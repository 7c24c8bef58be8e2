"""Scene object: a mesh instance with pose, physical and material properties.

Counterpart of ``stillleben_tpu/scene/object.py``, with the same API:
parity with the reference ``sl::Object`` / python binding (reference
src/object.cpp, python/src/py_object.cpp): pose with rigidity
validation (src/object.cpp:349-369), instance index with uint16 range
(src/object.cpp:376-382), static(->kinematic) flag, density/mass/velocities,
per-object friction/restitution (customizeMaterial, src/object.cpp:565-605),
render overrides metallic/roughness (-1 = no override) + specular/shininess
for phong (src/object.cpp:454-472), castsShadows, sticker projection
(src/object.cpp:494-513), serialization (src/object.cpp:384-452).
"""

from __future__ import annotations

import numpy as np
import torch

from ..assets.mesh import Mesh
from ..context import DEFAULT_DYNAMIC_FRICTION, DEFAULT_RESTITUTION, DEFAULT_STATIC_FRICTION
from ..core import math as m
from ..physics.bodies import (
    DEFAULT_DENSITY,
    aggregate_mass_properties,
    transform_mass_properties,
)


class Object:
    def __init__(self, mesh: Mesh, options: dict | None = None):
        options = options or {}
        self._mesh = mesh
        self._pose = np.eye(4, dtype=np.float32)
        self._instance_index = 0
        self._static = False
        self._density = DEFAULT_DENSITY
        self._mass_override: float | None = None
        # the reference clones the default PhysX material on first write
        # (src/object.cpp:565-605); we just carry scalars
        self._static_friction = DEFAULT_STATIC_FRICTION
        self._dynamic_friction = DEFAULT_DYNAMIC_FRICTION
        self._restitution = DEFAULT_RESTITUTION
        self._linear_velocity = np.zeros(3, np.float32)
        self._angular_velocity = np.zeros(3, np.float32)
        self._linear_velocity_limit = float("inf")
        self._lock_rotation = False  # solver-level angular lock (D6 joint)
        # render properties (reference defaults, include/stillleben/object.h)
        self._specular_color = np.ones(4, np.float32)
        self._shininess = 80.0
        self._roughness = -1.0  # -1 = no override
        self._metallic = -1.0
        self._casts_shadows = True
        self._sticker_texture = None
        self._sticker_range = np.zeros(4, np.float32)  # (x, y, w, h)
        self._sticker_rotation = np.array([1.0, 0, 0, 0], np.float32)  # wxyz
        # forced vertex color (python Object options {color, force_color},
        # reference py_object.cpp)
        self._color = np.asarray(options.get("color"), np.float32) if "color" in options else None
        self._force_color = bool(options.get("force_color", False))
        # contact bookkeeping (reference Object::m_separation / m_stuckCounter)
        self.separation = float("inf")
        self._stuck_counter = 0

    # -- pose ---------------------------------------------------------------

    def pose(self) -> np.ndarray:
        return self._pose.copy()

    def set_pose(self, pose) -> None:
        pose = np.asarray(pose, np.float32).reshape(4, 4)
        R = pose[:3, :3]
        if abs(np.linalg.det(R) - 1.0) > 1e-3 or np.abs(R @ R.T - np.eye(3)).max() > 1e-3:
            raise ValueError(f"Object pose is not rigid:\n{pose}")
        self._pose = pose

    def _set_pose_unchecked(self, pose: np.ndarray) -> None:
        self._pose = np.asarray(pose, np.float32).reshape(4, 4)

    # -- identity -----------------------------------------------------------

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def instance_index(self) -> int:
        return self._instance_index

    @instance_index.setter
    def instance_index(self, idx: int) -> None:
        if not (0 <= idx <= np.iinfo(np.uint16).max):
            raise ValueError("instance index out of uint16 range")
        self._instance_index = int(idx)

    # -- physics ------------------------------------------------------------

    @property
    def static(self) -> bool:
        return self._static

    @static.setter
    def static(self, v: bool) -> None:
        self._static = bool(v)

    def is_static(self) -> bool:
        return self._static

    @property
    def lock_rotation(self) -> bool:
        """Angular DOFs locked at the solver level: the body's inverse
        inertia is zeroed, so contact impulses cannot rotate it but reaction
        torques still propagate exactly to whatever it touches — the role of
        the reference's rotation-locked PxD6Joint to a world anchor
        (src/manipulation_sim.cpp:46-55)."""
        return self._lock_rotation

    @lock_rotation.setter
    def lock_rotation(self, v: bool) -> None:
        self._lock_rotation = bool(v)

    @property
    def density(self) -> float:
        return self._density

    @density.setter
    def density(self, d: float) -> None:
        self._density = float(d)
        self._mass_override = None

    def mass_properties(self):
        """(mass, com, inertia) in the mesh frame with pretransform applied."""
        self._mesh.load_physics()
        hulls = self._mesh._physics.hulls
        mass, com, inertia = aggregate_mass_properties(hulls, self._density)
        mass, com, inertia = transform_mass_properties(
            mass, com, inertia, self._mesh.pretransform
        )
        if self._mass_override is not None and mass > 0:
            scale = self._mass_override / mass
            mass *= scale
            inertia = inertia * scale
        return mass, com, inertia

    @property
    def mass(self) -> float:
        return self.mass_properties()[0]

    @mass.setter
    def mass(self, value: float) -> None:
        self._mass_override = float(value)

    @property
    def volume(self) -> float:
        self._mesh.load_physics()
        s = self._mesh.pretransform_scale
        return self._mesh._physics.total_volume * s**3

    @property
    def inertia(self) -> np.ndarray:
        return np.diag(self.mass_properties()[2]).copy()

    @property
    def inertial_frame(self) -> np.ndarray:
        """Pose of the inertial (COM) frame in world (reference
        Object::inertialFrame)."""
        _, com, inertia = self.mass_properties()
        w, V = np.linalg.eigh(inertia)
        if np.linalg.det(V) < 0:
            V[:, 2] *= -1
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = V.astype(np.float32)
        T[:3, 3] = com
        return (self._pose @ T).astype(np.float32)

    @property
    def linear_velocity(self) -> np.ndarray:
        return self._linear_velocity.copy()

    @linear_velocity.setter
    def linear_velocity(self, v) -> None:
        self._linear_velocity = np.asarray(v, np.float32).reshape(3)

    @property
    def angular_velocity(self) -> np.ndarray:
        return self._angular_velocity.copy()

    @angular_velocity.setter
    def angular_velocity(self, v) -> None:
        self._angular_velocity = np.asarray(v, np.float32).reshape(3)

    @property
    def linear_velocity_limit(self) -> float:
        return self._linear_velocity_limit

    @linear_velocity_limit.setter
    def linear_velocity_limit(self, v: float) -> None:
        self._linear_velocity_limit = float(v)

    @property
    def static_friction(self) -> float:
        return self._static_friction

    @static_friction.setter
    def static_friction(self, v: float) -> None:
        self._static_friction = float(v)

    @property
    def dynamic_friction(self) -> float:
        return self._dynamic_friction

    @dynamic_friction.setter
    def dynamic_friction(self, v: float) -> None:
        self._dynamic_friction = float(v)

    @property
    def restitution(self) -> float:
        return self._restitution

    @restitution.setter
    def restitution(self, v: float) -> None:
        self._restitution = float(v)

    # -- render properties ----------------------------------------------------

    @property
    def specular_color(self) -> np.ndarray:
        return self._specular_color.copy()

    @specular_color.setter
    def specular_color(self, c) -> None:
        self._specular_color = np.asarray(c, np.float32).reshape(-1)[:4]

    @property
    def shininess(self) -> float:
        return self._shininess

    @shininess.setter
    def shininess(self, v: float) -> None:
        self._shininess = float(v)

    @property
    def metallic(self) -> float:
        return self._metallic

    @metallic.setter
    def metallic(self, v: float) -> None:
        self._metallic = float(v)

    @property
    def roughness(self) -> float:
        return self._roughness

    @roughness.setter
    def roughness(self, v: float) -> None:
        self._roughness = float(v)

    @property
    def casts_shadows(self) -> bool:
        return self._casts_shadows

    @casts_shadows.setter
    def casts_shadows(self, v: bool) -> None:
        self._casts_shadows = bool(v)

    @property
    def color(self) -> np.ndarray | None:
        """The colour of the ``color`` option; with ``force_color`` it
        replaces the mesh's vertex colours."""
        return None if self._color is None else self._color.copy()

    @color.setter
    def color(self, c) -> None:
        self._color = None if c is None else np.asarray(c, np.float32)

    @property
    def force_color(self) -> bool:
        return self._force_color

    @force_color.setter
    def force_color(self, v: bool) -> None:
        self._force_color = bool(v)

    # -- sticker --------------------------------------------------------------

    @property
    def sticker_texture(self):
        return self._sticker_texture

    @sticker_texture.setter
    def sticker_texture(self, tex) -> None:
        self._sticker_texture = tex

    @property
    def sticker_range(self) -> np.ndarray:
        return self._sticker_range.copy()

    @sticker_range.setter
    def sticker_range(self, r) -> None:
        self._sticker_range = np.asarray(r, np.float32).reshape(4)

    @property
    def sticker_rotation(self) -> np.ndarray:
        return self._sticker_rotation.copy()

    @sticker_rotation.setter
    def sticker_rotation(self, q) -> None:
        self._sticker_rotation = np.asarray(q, np.float32).reshape(4)

    def sticker_view_projection(self) -> np.ndarray:
        """Ortho-ish frustum projecting the sticker onto the object
        (reference src/object.cpp:494-513, row-major here)."""
        diagonal = self._mesh.bbox.diagonal
        proj = np.array(
            [
                [2.0 / diagonal, 0, 0, 0],
                [0, 2.0 / diagonal, 0, 0],
                [0, 0, 1, 1],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        trans = np.eye(4, dtype=np.float32)
        trans[2, 3] = 1.0
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = m.quat_to_matrix(torch.from_numpy(self._sticker_rotation)).numpy()
        return proj @ trans @ rot

    # -- serialization ---------------------------------------------------------

    def serialize_config(self, group) -> None:
        """Write this object into a Corrade ConfigurationGroup
        (reference src/object.cpp:384-405; same keys incl. the reference's
        ``linear_velocity_limit`` spelling on write)."""
        mesh_group = group.add_group("mesh")
        self._mesh.serialize_config(mesh_group)
        group.set_value("pose", self._pose)
        group.set_value("instanceIndex", int(self._instance_index))
        group.set_value("specularColor", self._specular_color)
        group.set_value("shininess", float(self._shininess))
        group.set_value("roughness", float(self._roughness))
        group.set_value("metallic", float(self._metallic))
        group.set_value("casts_shadows", bool(self._casts_shadows))
        x, y, w, h = [float(v) for v in self._sticker_range]
        group.set_value("stickerRange", np.array([x, y, x + w, y + h], np.float32))
        from ..utils.corrade_config import fmt_quaternion_wxyz

        group.set_value("stickerRotation", fmt_quaternion_wxyz(self._sticker_rotation))
        group.set_value("static", bool(self._static))
        group.set_value("density", float(self._density))
        group.set_value("linear_velocity_limit", float(self._linear_velocity_limit))

    @staticmethod
    def deserialize_config(group, cache=None) -> "Object":
        """(reference src/object.cpp:407-452; accepts both the reference's
        write spelling ``linear_velocity_limit`` and its read spelling
        ``linearVelocityLimit``)."""
        from ..utils.corrade_config import (
            parse_bool,
            parse_floats,
            parse_matrix,
            parse_quaternion_wxyz,
        )

        mesh_group = group.group("mesh")
        if mesh_group is None:
            raise RuntimeError("Did not find mesh subgroup in object")
        obj = Object(Mesh.deserialize_config(mesh_group, cache))
        if group.has_value("pose"):
            obj.set_pose(parse_matrix(group.value("pose")))
        if group.has_value("instanceIndex"):
            obj.instance_index = int(group.value("instanceIndex"))
        if group.has_value("specularColor"):
            obj.specular_color = parse_floats(group.value("specularColor"), 4)
        for key, attr in [
            ("shininess", "shininess"),
            ("roughness", "roughness"),
            ("metallic", "metallic"),
            ("density", "density"),
        ]:
            if group.has_value(key):
                setattr(obj, attr, float(group.value(key)))
        if group.has_value("casts_shadows"):
            obj.casts_shadows = parse_bool(group.value("casts_shadows"))
        if group.has_value("static"):
            obj.static = parse_bool(group.value("static"))
        if group.has_value("stickerRange"):
            x0, y0, x1, y1 = parse_floats(group.value("stickerRange"), 4)
            obj.sticker_range = np.array([x0, y0, x1 - x0, y1 - y0], np.float32)
        if group.has_value("stickerRotation"):
            obj.sticker_rotation = parse_quaternion_wxyz(group.value("stickerRotation"))
        for key in ("linear_velocity_limit", "linearVelocityLimit"):
            if group.has_value(key):
                obj.linear_velocity_limit = float(group.value(key))
                break
        return obj

    def serialize(self) -> dict:
        d = {
            "mesh": self._mesh.serialize(),
            "pose": self._pose.reshape(-1).tolist(),
            "instanceIndex": self._instance_index,
            "specularColor": self._specular_color.tolist(),
            "shininess": self._shininess,
            "metallic": self._metallic,
            "roughness": self._roughness,
            "static": self._static,
            "density": self._density,
        }
        if np.isfinite(self._linear_velocity_limit):
            d["linearVelocityLimit"] = self._linear_velocity_limit
        if np.any(self._sticker_range):
            d["stickerRange"] = self._sticker_range.tolist()
            d["stickerRotation"] = self._sticker_rotation.tolist()
        return d

    @staticmethod
    def deserialize(group: dict, cache=None) -> "Object":
        mesh = Mesh.deserialize(group["mesh"], cache)
        obj = Object(mesh)
        if "pose" in group:
            obj.set_pose(np.array(group["pose"], np.float32).reshape(4, 4))
        for key, attr in [
            ("instanceIndex", "instance_index"),
            ("shininess", "shininess"),
            ("metallic", "metallic"),
            ("roughness", "roughness"),
            ("static", "static"),
            ("density", "density"),
            ("linearVelocityLimit", "linear_velocity_limit"),
        ]:
            if key in group:
                setattr(obj, attr, group[key])
        if "specularColor" in group:
            obj.specular_color = group["specularColor"]
        if "stickerRange" in group:
            obj.sticker_range = group["stickerRange"]
        if "stickerRotation" in group:
            obj.sticker_rotation = group["stickerRotation"]
        return obj
