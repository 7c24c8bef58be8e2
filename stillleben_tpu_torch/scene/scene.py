"""The Scene: camera, lights, background, objects, physics.

Counterpart of ``stillleben_tpu/scene/scene.py``, with the same API
(reference ``sl::Scene``, src/scene.cpp, python/src/py_scene.cpp): the
camera with the 58 degree default horizontal field of view and the
CV-convention projection, 3 directional lights (the first of radiance 300),
a white background colour, the background plane, the tabletop simulation
with the reference's 100 x 4-substep schedule and redrop, the pose
samplers, collision queries, and text serialization (Corrade or JSON).

The physics state lives on the context's device (``context.init``):
``_compile`` packs the object set into padded tensors there once per
change of the set (its stamp), and ``simulate*`` step the port's batched
engine with a batch of one, then write the poses back to the Objects.

Randomness: the plane yaw, ``place_object_randomly`` and the pose samplers
draw from ``self._rng``, a numpy ``Generator`` seeded as in the JAX
package, so one seed gives both packages the same values. The JAX package
draws the stack orientations and the camera rotation from a JAX key; the
port draws them from ``self._generator`` (a CPU ``torch.Generator``),
each through one method (``_stack_quaternions``, ``_camera_rotation``).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..context import context
from ..core import math as m
from ..core.tree import tensors_from_numpy
from ..physics import tabletop as tt
from ..physics.bodies import transform_hull
from ..physics.contacts import Floor, hull_pairs_host, make_floor
from ..physics.engine import check_overlaps, step as physics_step
from ..physics.types import BodyParams, BodyState, HullAtlas, build_hull_atlas_numpy, default_config
from ..render import camera as cam
from ..utils import sanitize
from . import pose as pose_samplers
from .camera_fit import (
    choose_random_light_direction, fit_camera_position, light_normals, random_camera_rotation,
)
from .object import Object

NUM_LIGHTS = 3  # reference include/stillleben/common.h:17


class Scene:
    def __init__(self, viewport: tuple[int, int] = (640, 480)):
        """``viewport`` is (W, H), as in the reference's python binding."""
        self._viewport = (int(viewport[0]), int(viewport[1]))
        self._camera_pose = np.eye(4, dtype=np.float32)
        self._projection = cam.projection_from_fov(
            math.radians(cam.DEFAULT_HFOV_DEG), *self._viewport, device="cpu"
        ).numpy()
        self._objects: list[Object] = []

        self._light_directions = np.zeros((NUM_LIGHTS, 3), np.float32)
        self._light_colors = np.zeros((NUM_LIGHTS, 3), np.float32)
        self._light_colors[0] = 300.0  # radiance units (scene.h:226-230)
        self._ambient_light = np.zeros(3, np.float32)
        self._light_map = None  # a render.light_map.LightMap

        self._background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self._background_image = None  # a Texture, drawn behind everything
        self._background_plane_pose = np.eye(4, dtype=np.float32)
        self._background_plane_size = np.zeros(2, np.float32)  # zeros = no plane
        self._background_plane_texture = None  # a Texture2D

        self._manual_exposure = -1.0

        self._rng = np.random.default_rng()
        self._generator = torch.Generator().manual_seed(int.from_bytes(os.urandom(4), "little"))

        self._gravity = (0.0, 0.0, -9.81)
        self._solver_cfg = default_config(self._gravity)
        self._compiled = None  # (atlas, params, pairs, geom) on one device
        self._compiled_key = None

    # -- misc -----------------------------------------------------------------

    def seed(self, seed: int) -> None:
        """Deterministic randomness for tests and datagen."""
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator().manual_seed(seed)

    @property
    def viewport(self) -> tuple[int, int]:
        return self._viewport

    @property
    def device(self) -> torch.device:
        """Where the physics state lives: the context's device."""
        return context().device

    # -- camera -----------------------------------------------------------------

    def camera_pose(self) -> np.ndarray:
        return self._camera_pose.copy()

    def set_camera_pose(self, pose) -> None:
        pose = np.asarray(pose, np.float32).reshape(4, 4)
        R = pose[:3, :3]
        if abs(np.linalg.det(R) - 1.0) > 1e-3 or np.abs(R @ R.T - np.eye(3)).max() > 1e-3:
            raise ValueError(f"Camera pose is not rigid:\n{pose}")
        self._camera_pose = pose

    def set_camera_look_at(self, position, look_at, up=(0.0, 0.0, 1.0)) -> None:
        """+Z-forward camera look-at (reference src/scene.cpp:205-215)."""
        t = [torch.as_tensor(np.asarray(x, np.float32)) for x in (position, look_at, up)]
        self._camera_pose = m.look_at(*t).numpy()

    def set_camera_intrinsics(self, fx, fy, cx, cy) -> None:
        W, H = self._viewport
        self._projection = cam.projection_from_intrinsics(fx, fy, cx, cy, W, H, device="cpu").numpy()

    def set_camera_hfov(self, hfov: float) -> None:
        W, H = self._viewport
        self._projection = cam.projection_from_fov(hfov, W, H, device="cpu").numpy()

    def set_camera_projection(self, P) -> None:
        self._projection = np.asarray(P, np.float32).reshape(4, 4)

    def projection_matrix(self) -> np.ndarray:
        return self._projection.copy()

    def camera_to_world(self, pose_in_camera) -> np.ndarray:
        return (self._camera_pose @ np.asarray(pose_in_camera, np.float32)).astype(np.float32)

    def min_dist_for_object_diameter(self, diameter: float) -> float:
        P = torch.from_numpy(self._projection)
        return float(cam.minimum_distance_for_object_diameter(diameter, P))

    def place_object_randomly(
        self, diameter: float, min_size_factor: float = pose_samplers.DEFAULT_MIN_SIZE_FACTOR
    ) -> np.ndarray:
        ps = pose_samplers.RandomPositionSampler(self._projection, diameter)
        ps.min_size_factor = min_size_factor
        return pose_samplers.RandomPoseSampler(ps)(self._rng)

    # -- lights -------------------------------------------------------------------

    @property
    def light_directions(self) -> np.ndarray:
        """(NumLights, 3), the array itself; assign to change it."""
        return self._light_directions

    @light_directions.setter
    def light_directions(self, dirs) -> None:
        dirs = np.asarray(dirs, np.float32).reshape(-1, 3)
        if dirs.shape[0] > NUM_LIGHTS:
            raise ValueError("Cannot support that many lights")
        self._light_directions[:] = 0
        self._light_directions[: dirs.shape[0]] = dirs

    @property
    def light_colors(self) -> np.ndarray:
        return self._light_colors

    @light_colors.setter
    def light_colors(self, colors) -> None:
        colors = np.asarray(colors, np.float32).reshape(-1, 3)
        if colors.shape[0] > NUM_LIGHTS:
            raise ValueError("Cannot support that many lights")
        self._light_colors[:] = 0
        self._light_colors[: colors.shape[0]] = colors

    @property
    def ambient_light(self) -> np.ndarray:
        return self._ambient_light.copy()

    @ambient_light.setter
    def ambient_light(self, c) -> None:
        self._ambient_light = np.asarray(c, np.float32).reshape(3)

    @property
    def light_map(self):
        return self._light_map

    @light_map.setter
    def light_map(self, lm) -> None:
        self._light_map = lm

    def choose_random_light_direction(self) -> None:
        """(reference src/scene.cpp:453-470)"""
        d = choose_random_light_direction(light_normals(1, self._generator),
                                          torch.from_numpy(self._camera_pose)[None])
        self.light_directions = d.numpy()

    # deprecated alias used by the reference's examples/ycb.py
    choose_random_light_position = choose_random_light_direction

    @property
    def manual_exposure(self) -> float:
        return self._manual_exposure

    @manual_exposure.setter
    def manual_exposure(self, v: float) -> None:
        self._manual_exposure = float(v)

    # -- background ------------------------------------------------------------------

    @property
    def background_color(self) -> np.ndarray:
        return self._background_color.copy()

    @background_color.setter
    def background_color(self, c) -> None:
        self._background_color = np.asarray(c, np.float32).reshape(4)

    @property
    def background_image(self):
        return self._background_image

    @background_image.setter
    def background_image(self, tex) -> None:
        self._background_image = tex

    @property
    def background_plane_pose(self) -> np.ndarray:
        return self._background_plane_pose.copy()

    @background_plane_pose.setter
    def background_plane_pose(self, pose) -> None:
        self._background_plane_pose = np.asarray(pose, np.float32).reshape(4, 4)

    @property
    def background_plane_size(self) -> np.ndarray:
        return self._background_plane_size.copy()

    @background_plane_size.setter
    def background_plane_size(self, size) -> None:
        self._background_plane_size = np.asarray(size, np.float32).reshape(2)

    @property
    def background_plane_texture(self):
        return self._background_plane_texture

    @background_plane_texture.setter
    def background_plane_texture(self, tex) -> None:
        self._background_plane_texture = tex

    # -- objects ------------------------------------------------------------------------

    def add_object(self, obj: Object) -> None:
        """Appends; an instance index of 0 becomes the 1-based position
        (reference src/scene.cpp:279-289)."""
        self._objects.append(obj)
        if obj.instance_index == 0:
            obj.instance_index = len(self._objects)
        self._invalidate()

    def remove_object(self, obj: Object) -> None:
        if obj in self._objects:
            self._objects.remove(obj)
            self._invalidate()

    @property
    def objects(self) -> list[Object]:
        return list(self._objects)

    def clear_objects(self) -> None:
        self._objects.clear()
        self._invalidate()

    def load_visual(self) -> None:
        for o in self._objects:
            o.mesh.load_visual()

    def load_physics(self) -> None:
        for o in self._objects:
            o.mesh.load_physics()

    # -- physics compilation -----------------------------------------------------------

    def _invalidate(self) -> None:
        self._compiled = None
        self._compiled_key = None

    def _stamp(self) -> tuple:
        return tuple(
            (id(o), o.mesh._dirty, o.static, o.density, o._mass_override,
             o.static_friction, o.dynamic_friction, o.restitution,
             o.linear_velocity_limit, o.lock_rotation)
            for o in self._objects
        )

    def _compile(self, device=None) -> tuple[HullAtlas, BodyParams, torch.Tensor, tt.TabletopGeom]:
        """The object set as padded tensors on ``device`` (default: the
        context's), cached until the set or a body property changes
        (scene.py:299-373)."""
        dev = torch.device(device) if device is not None else self.device
        key = (self._stamp(), dev)
        if self._compiled is not None and self._compiled_key == key:
            return self._compiled
        self.load_physics()
        nb = max(len(self._objects), 1)
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
        for i, o in enumerate(self._objects):
            P = o.mesh.pretransform
            hull_lists.append([transform_hull(h, P) for h in o.mesh._physics.hulls])
            mass, c, inertia = o.mass_properties()
            if not o.static and mass > 0:
                inv_mass[i] = 1.0 / mass
                inv_inertia[i] = np.linalg.inv(inertia + 1e-12 * np.eye(3)).astype(np.float32)
            if o.lock_rotation:  # the solver-level rotation lock (Object.lock_rotation)
                inv_inertia[i] = 0.0
            com[i] = c
            # per-body material; contacts average the two bodies' values
            friction[i] = o.dynamic_friction
            friction_static[i] = o.static_friction
            restitution[i] = o.restitution
            vel_limit[i] = min(o.linear_velocity_limit, 3.4e38)
            valid[i] = True
            kinematic[i] = o.static
            bbox = o.mesh.bbox
            diameter[i] = bbox.diagonal
            bbox_center[i] = bbox.center
            dynamic[i] = not o.static
        if not self._objects:
            hull_lists.append([])
        hulls = build_hull_atlas_numpy(hull_lists)
        params = dict(
            inv_mass=inv_mass, inv_inertia_body=inv_inertia, com=com, friction=friction,
            friction_static=friction_static, restitution=restitution,
            linear_velocity_limit=vel_limit, valid=valid, kinematic=kinematic,
        )
        geom = dict(diameter=diameter, bbox_center=bbox_center, dynamic=dynamic)
        self._compiled = (
            tensors_from_numpy(HullAtlas, hulls, dev),
            tensors_from_numpy(BodyParams, params, dev),
            torch.from_numpy(hull_pairs_host(hulls["hull_body"], hulls["hull_valid"])).to(dev),
            tensors_from_numpy(tt.TabletopGeom, geom, dev),
        )
        self._compiled_key = key
        return self._compiled

    def _state_from_objects(self, device) -> BodyState:
        nb = max(len(self._objects), 1)
        pos = np.zeros((1, nb, 3), np.float32)
        rot = np.tile(np.eye(3, dtype=np.float32), (1, nb, 1, 1))
        lin = np.zeros((1, nb, 3), np.float32)
        ang = np.zeros((1, nb, 3), np.float32)
        for i, o in enumerate(self._objects):
            T = o.pose()
            pos[0, i] = T[:3, 3]
            rot[0, i] = T[:3, :3]
            lin[0, i] = o.linear_velocity
            ang[0, i] = o.angular_velocity
        quat = m.matrix_to_quat(torch.from_numpy(rot))
        return BodyState(*(torch.as_tensor(x).to(device) for x in (pos, quat, lin, ang)))

    def _write_back(self, state: BodyState, report=None) -> None:
        pos, quat, lin, ang = (x[0].cpu() for x in state)
        R = m.quat_to_matrix(quat).numpy()
        pos, lin, ang = pos.numpy(), lin.numpy(), ang.numpy()
        seps = report.min_separation[0].cpu().numpy() if report is not None else None
        for i, o in enumerate(self._objects):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R[i]
            T[:3, 3] = pos[i]
            o._set_pose_unchecked(T)
            o._linear_velocity = lin[i].copy()
            o._angular_velocity = ang[i].copy()
            if seps is not None:
                o.separation = float(seps[i])

    def _default_floor(self, enabled: bool, device=None) -> Floor:
        """The tabletop floor (scene.py:408-411)."""
        return make_floor(height=tt.FLOOR_TOP_Z, enabled=enabled, friction=0.5, restitution=0.0,
                          device=device if device is not None else self.device)

    def _stack_quaternions(self, nb: int) -> torch.Tensor:
        """(1, nb, 4) orientations of the tabletop stack, from the generator."""
        return m.random_quaternion((1, nb), self._generator)

    def _camera_rotation(self) -> torch.Tensor:
        """(1, 3, 3) rotation of a random camera, from the generator."""
        return random_camera_rotation(1, self._generator, "cpu")

    # -- simulation -------------------------------------------------------------------

    @property
    def gravity(self):
        return np.asarray(self._gravity, np.float32)

    @gravity.setter
    def gravity(self, g) -> None:
        self._gravity = tuple(float(x) for x in np.asarray(g).reshape(3))
        self._solver_cfg = default_config(self._gravity)

    def simulate(self, dt: float) -> None:
        """One physics step and the pose write-back (reference
        src/scene.cpp:903-912). No implicit floor: only the scene's objects
        collide."""
        atlas, params, pairs, _ = self._compile()
        state = self._state_from_objects(self.device)
        state, report = physics_step(atlas, params, state, self._default_floor(False), pairs,
                                     float(dt), self._solver_cfg)
        self._write_back(state, report)

    def simulate_tabletop_scene(self, vis_cb=None) -> None:
        """(reference src/scene.cpp:612-759). ``vis_cb(i)`` is called before
        each of the 100 frames, the poses written back after each."""
        atlas, params, pairs, geom = self._compile()
        dev = self.device
        all_dynamic = all(not o.static for o in self._objects)
        floor = self._default_floor(all_dynamic)
        base_z = torch.tensor(tt.FLOOR_TOP_Z if all_dynamic else tt.STACK_BASE_STATIC,
                              dtype=torch.float32, device=dev)
        if all_dynamic:
            # the visual plane's random yaw, so the visual matches physics
            # (reference src/scene.cpp:655-663)
            yaw = self._rng.uniform(-np.pi, np.pi)
            Rz = np.eye(4, dtype=np.float32)
            Rz[:3, :3] = m.rotation_z(torch.tensor(yaw, dtype=torch.float32)).numpy()
            offset = np.eye(4, dtype=np.float32)
            offset[2, 3] = tt.FLOOR_TOP_Z
            self.background_plane_pose = Rz @ offset
        quats = self._stack_quaternions(geom.diameter.shape[0]).to(dev)
        if vis_cb is None:
            state = tt.simulate_tabletop(atlas, params, floor, pairs, geom, self._solver_cfg,
                                         base_z, quats)
        else:
            state = tt.stack_objects(geom, base_z, quats)
            for i in range(tt.MAX_ITERATIONS):
                vis_cb(i)
                state = tt.settle(atlas, params, state, floor, pairs, geom, self._solver_cfg,
                                  iterations=1)
                self._write_back(state)
        if sanitize.enabled():  # SL_SANITIZE=1: NaN/Inf audit of the settled state
            sanitize.check_finite(state, "simulate_tabletop_scene state")
        self._write_back(state)
        self.choose_random_camera_pose()

    def choose_random_camera_pose(self) -> None:
        """A random camera that sees every object's bounding box
        (reference src/scene.cpp:472-610)."""
        corners = []
        for o in self._objects:
            c = o.mesh.bbox.corners()  # (8, 3) in the pretransformed mesh frame
            T = o.pose()
            corners.append(c @ T[:3, :3].T + T[:3, 3])
        R = self._camera_rotation()
        if corners:
            pts = torch.from_numpy(np.concatenate(corners, axis=0).astype(np.float32))[None]
            valid = torch.ones(pts.shape[:2], dtype=torch.bool)
            pos = fit_camera_position(R, torch.from_numpy(self._projection), pts, valid)
        else:  # the reference's fallback translation
            pos = R @ torch.tensor([0.0, 0.0, -1.0])
        self._camera_pose = m.make_transform(R, pos)[0].numpy()

    def check_collisions(self) -> list[bool]:
        """(reference src/scene.cpp:914-925)"""
        atlas, params, pairs, _ = self._compile()
        hits = check_overlaps(atlas, params, self._state_from_objects(self.device), pairs)
        return [bool(h) for h in hits[0, : len(self._objects)].tolist()]

    def is_object_colliding(self, obj: Object) -> bool:
        return self.check_collisions()[self._objects.index(obj)]

    def find_noncolliding_pose(
        self, obj: Object, sampler: str = "random", max_iterations: int = 10, **kwargs
    ) -> bool:
        """(reference py_scene.cpp:193-259, scene.h:245-261)"""
        ps = pose_samplers.RandomPositionSampler(self._projection, obj.mesh.bbox.diagonal)
        if "min_size_factor" in kwargs:
            ps.min_size_factor = float(kwargs["min_size_factor"])
        if sampler == "random":
            s = pose_samplers.RandomPoseSampler(ps)
        elif sampler == "viewpoint":
            if "viewpoint" not in kwargs:
                raise ValueError("sampler='viewpoint' needs viewpoint argument")
            s = pose_samplers.ViewPointPoseSampler(ps)
            s.view_point = np.asarray(kwargs["viewpoint"], np.float32).reshape(3)
        elif sampler == "view_corrected":
            if "orientation" not in kwargs:
                raise ValueError("sampler='view_corrected' needs orientation argument")
            s = pose_samplers.ViewCorrectedPoseSampler(
                ps, np.asarray(kwargs["orientation"], np.float32)
            )
        else:
            raise ValueError(f"Unknown sampler {sampler!r}")
        for _ in range(max_iterations):
            obj.set_pose(s(self._rng))
            if not self.is_object_colliding(obj):
                return True
        return False

    # -- serialization ------------------------------------------------------------------

    def serialize(self, format: str = "corrade") -> str:
        """Text in the reference's Corrade Configuration format
        (src/scene.cpp:761-799; include/stillleben/scene.h:41-67), or the
        JAX package's JSON schema with ``format="json"``."""
        if format == "json":
            return self._serialize_json()
        from ..utils.corrade_config import ConfigurationGroup, fmt_quaternion_wxyz, save

        root = ConfigurationGroup()
        root.set_value("viewport", np.asarray(self._viewport, np.int32))
        root.set_value("projection", self._projection)
        root.set_value("cameraPosition", self._camera_pose[:3, 3])
        q = m.matrix_to_quat(torch.from_numpy(np.ascontiguousarray(self._camera_pose[:3, :3])))
        root.set_value("cameraRotation", fmt_quaternion_wxyz(q.numpy()))
        for i in range(len(self._light_directions)):
            lg = root.add_group("light")
            lg.set_value("direction", self._light_directions[i])
            lg.set_value("color", self._light_colors[i])
        root.set_value("ambientLight", self._ambient_light)
        root.set_value("numObjects", len(self._objects))
        for o in self._objects:
            o.serialize_config(root.add_group("object"))
        if self._light_map is not None and getattr(self._light_map, "path", None):
            root.set_value("lightMap", self._light_map.path)
        root.set_value("backgroundPlanePose", self._background_plane_pose)
        root.set_value("backgroundPlaneSize", self._background_plane_size)
        root.set_value("manualExposure", float(self._manual_exposure))
        return save(root)

    def _serialize_json(self) -> str:
        d = {
            "viewport": list(self._viewport),
            "projection": self._projection.reshape(-1).tolist(),
            "cameraPose": self._camera_pose.reshape(-1).tolist(),
            "lightDirections": self._light_directions.tolist(),
            "lightColors": self._light_colors.tolist(),
            "ambientLight": self._ambient_light.tolist(),
            "backgroundColor": self._background_color.tolist(),
            "backgroundPlanePose": self._background_plane_pose.reshape(-1).tolist(),
            "backgroundPlaneSize": self._background_plane_size.tolist(),
            "manualExposure": self._manual_exposure,
            "objects": [o.serialize() for o in self._objects],
        }
        if self._light_map is not None and getattr(self._light_map, "path", None):
            d["lightMap"] = self._light_map.path
        return json.dumps(d, indent=1)

    def deserialize(self, text: str, cache=None) -> None:
        """Load a serialized scene, Corrade text (the reference's schema,
        src/scene.cpp:801-869) or JSON, told apart by the first character."""
        if text.lstrip().startswith("{"):
            return self._deserialize_json(text, cache)
        from ..utils.corrade_config import parse, parse_floats, parse_matrix, parse_quaternion_wxyz

        g = parse(text)
        if g.has_value("viewport"):
            self._viewport = tuple(int(float(x)) for x in g.value("viewport").split())
        if g.has_value("projection"):
            self._projection = parse_matrix(g.value("projection"))
        if g.has_value("cameraPosition") and g.has_value("cameraRotation"):
            pose = np.eye(4, dtype=np.float32)
            quat = parse_quaternion_wxyz(g.value("cameraRotation"))
            pose[:3, :3] = m.quat_to_matrix(torch.from_numpy(quat)).numpy()
            pose[:3, 3] = parse_floats(g.value("cameraPosition"), 3)
            self._camera_pose = pose
        elif g.has_value("cameraPose"):
            self._camera_pose = parse_matrix(g.value("cameraPose"))
        if g.has_value("lightPosition"):
            # legacy single-light scenes (reference src/scene.cpp:816-820)
            p = parse_floats(g.value("lightPosition"), 3)
            n = p / max(float(np.linalg.norm(p)), 1e-12)
            self._light_directions = (-n).reshape(1, 3).astype(np.float32)
            self._light_colors = np.array([[0.0, 0.8, 0.0]], np.float32)
        else:
            lights = g.groups("light")
            if lights:
                self._light_directions = np.stack(
                    [parse_floats(lg.value("direction"), 3) for lg in lights]
                )
                self._light_colors = np.stack([parse_floats(lg.value("color"), 3) for lg in lights])
        if g.has_value("ambientLight"):
            self._ambient_light = parse_floats(g.value("ambientLight"), 3)
        if g.has_value("lightMap"):
            from ..render.light_map import LightMap

            self._light_map = LightMap(g.value("lightMap"), device=self.device)
        if g.has_value("backgroundPlanePose"):
            self._background_plane_pose = parse_matrix(g.value("backgroundPlanePose"))
        if g.has_value("backgroundPlaneSize"):
            self._background_plane_size = parse_floats(g.value("backgroundPlaneSize"), 2)
        if g.has_value("manualExposure"):
            self._manual_exposure = float(g.value("manualExposure"))
        if cache is None:
            from ..assets.mesh import MeshCache

            cache = MeshCache()
        self._objects = [Object.deserialize_config(og, cache) for og in g.groups("object")]
        self._invalidate()

    def _deserialize_json(self, text: str, cache=None) -> None:
        d = json.loads(text)
        if "viewport" in d:
            self._viewport = tuple(int(x) for x in d["viewport"])
        for key, attr, shape in (
            ("projection", "_projection", (4, 4)),
            ("cameraPose", "_camera_pose", (4, 4)),
            ("lightDirections", "_light_directions", (-1, 3)),
            ("lightColors", "_light_colors", (-1, 3)),
            ("ambientLight", "_ambient_light", (3,)),
            ("backgroundColor", "_background_color", (4,)),
            ("backgroundPlanePose", "_background_plane_pose", (4, 4)),
            ("backgroundPlaneSize", "_background_plane_size", (2,)),
        ):
            if key in d:
                setattr(self, attr, np.array(d[key], np.float32).reshape(shape))
        if "manualExposure" in d:
            self._manual_exposure = float(d["manualExposure"])
        if "lightMap" in d:
            from ..render.light_map import LightMap

            self._light_map = LightMap(d["lightMap"], device=self.device)
        self._objects = [Object.deserialize(og, cache) for og in d.get("objects", [])]
        self._invalidate()

    # deprecated alias (reference py_scene.cpp light_position)
    @property
    def light_position(self) -> np.ndarray:
        return -self._light_directions[0]

    @light_position.setter
    def light_position(self, p) -> None:
        self.light_directions = -np.asarray(p, np.float32).reshape(1, 3)
