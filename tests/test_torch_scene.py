"""The port's host API below the render against the JAX package on the CPU:
``core/math``, ``core/quat``, ``render/camera``, ``Object``, ``Scene``
serialization, the pose samplers, the collision query and the physics
calls of ``Scene``.

Tolerances: the math and camera functions 1e-6 on the same numpy inputs;
mass, inertia and inertial frame 1e-5 relative; ``serialize()`` the same
text in both formats, and each package's ``deserialize`` of the other's
text gives the same poses and properties; ``place_object_randomly`` and
``find_noncolliding_pose`` under all three samplers draw from the same
numpy stream and give the same poses (1e-6, the rotation math's rounding)
and the same answers; ``check_collisions`` the same list; ``simulate(0.002)``
one step within 1e-5, ``simulate_steps`` over 10 steps and ``run_substeps``
within 1e-4. ``simulate_tabletop_scene`` is chaotic after the stack, so it
is held as ``test_torch_physics.py`` holds the settle (every body at rest
on the floor in both packages, from the same stack orientations), with the
plane's random yaw within 1e-5 and the camera pose, fitted to the same
poses from the same rotation, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
from stillleben_tpu.core import math as jm
from stillleben_tpu.core import quat as jquat
from stillleben_tpu.physics import engine as jengine
from stillleben_tpu.physics import tabletop as jtt
from stillleben_tpu.render import camera as jcam
from stillleben_tpu.scene import camera_fit as jfit
from stillleben_tpu.scene import scene as jscene_mod
from stillleben_tpu_torch.core import math as m
from stillleben_tpu_torch.core import quat as pquat
from stillleben_tpu_torch.physics import engine
from stillleben_tpu_torch.physics.contacts import world_hull_verts
from stillleben_tpu_torch.physics.types import make_empty_state
from stillleben_tpu_torch.render import camera as pcam
from torch_port_scene import build_meshes


@pytest.fixture(scope="module", autouse=True)
def cpu_context():
    sl.init(device="cpu")


def _rng_arrays(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    R = np.asarray(jm.quat_to_matrix(jnp.asarray(q)))
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(5, 3))
    noisy = (R + 0.01 * rng.normal(size=R.shape)).astype(np.float32)
    return dict(q=q, q2=q[::-1].copy(), v=v, R=R, T=T, noisy=noisy,
                T2=np.concatenate([T, T * np.float32(1.1)]),
                pv=np.concatenate([v, [[0.9, 0.1, 0.0]]]).astype(np.float32),
                angle=rng.uniform(-3, 3, 5).astype(np.float32),
                t=np.float32(0.3), up=np.array([0.0, 0.0, 1.0], np.float32))


MATH_CASES = {
    "cross_matrix": lambda f, a: f.cross_matrix(a["v"]),
    "quat_identity": lambda f, a: f.quat_identity(),
    "quat_rotate": lambda f, a: f.quat_rotate(a["q"], a["v"]),
    "matrix_to_quat": lambda f, a: f.matrix_to_quat(a["R"]),
    "matrix_to_quat_4x4": lambda f, a: f.matrix_to_quat(a["T"]),
    "quat_slerp": lambda f, a: f.quat_slerp(a["q"], a["q2"], a["t"]),
    "transform_point": lambda f, a: f.transform_point(a["T"], a["v"]),
    "transform_vector": lambda f, a: f.transform_vector(a["T"], a["v"]),
    "rotation_x": lambda f, a: f.rotation_x(a["angle"]),
    "axis_angle_to_matrix": lambda f, a: f.axis_angle_to_matrix(a["v"], a["angle"]),
    "orthonormalize": lambda f, a: f.orthonormalize(a["noisy"]),
    "is_rigid": lambda f, a: f.is_rigid(a["T2"]),
    "look_at": lambda f, a: f.look_at(a["v"][0], a["v"][1], a["up"]),
    "perpendicular_vector": lambda f, a: f.perpendicular_vector(a["pv"]),
}


def _jax_in(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _torch_in(a):
    return {k: torch.from_numpy(np.array(v)) for k, v in a.items()}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_core_math_matches_jax(name):
    """Each added ``core/math`` function on the same seeded inputs, 1e-6."""
    a = _rng_arrays(3)
    want = np.asarray(MATH_CASES[name](jm, _jax_in(a)))
    got = MATH_CASES[name](m, _torch_in(a)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_core_quat_matches_jax():
    """The numpy-facing xyzw helpers, 1e-6."""
    a = _rng_arrays(4)
    xyzw = a["q"][:, [1, 2, 3, 0]]
    np.testing.assert_allclose(pquat.quat_to_matrix(xyzw), jquat.quat_to_matrix(xyzw), atol=1e-6)
    np.testing.assert_allclose(pquat.matrix_to_quat(a["T"]), jquat.matrix_to_quat(a["T"]),
                               atol=1e-6)


CAMERA_CASES = {
    "intrinsics_from_projection": lambda c, P, a: c.intrinsics_from_projection(P, 160, 120),
    "project_points": lambda c, P, a: c.project_points(P, a["v"] + a["z5"], 160, 120),
    "minimum_distance_for_object_diameter":
        lambda c, P, a: c.minimum_distance_for_object_diameter(0.3, P),
    "rotation_correction_for_translation":
        lambda c, P, a: c.rotation_correction_for_translation(a["v"][2]),
}


@pytest.mark.parametrize("name", sorted(CAMERA_CASES))
def test_camera_matches_jax(name):
    """The added ``render/camera`` functions on a non-centred projection, 1e-6."""
    a = _rng_arrays(5)
    a["z5"] = np.array([0.0, 0.0, 5.0], np.float32)
    P = np.asarray(jcam.projection_from_intrinsics(150.0, 140.0, 83.0, 57.0, 160, 120))
    want = CAMERA_CASES[name](jcam, jnp.asarray(P), _jax_in(a))
    got = CAMERA_CASES[name](pcam, torch.from_numpy(P), _torch_in(a))
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert pcam.CameraParams(160, 120) == pcam.CameraParams(160, 120, 0.1, 10.0)


def test_make_empty_state():
    s = make_empty_state(3, device="cpu")
    assert s.pos.shape == (1, 3, 3) and (s.quat[..., 0] == 1).all() and s.lin_vel.abs().sum() == 0


# --- objects and scenes of both packages ---------------------------------------


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("meshes"))
    return (build_meshes(d, native_decomp=False),
            build_meshes(d, port=True, native_decomp=False), d)


def _scenes(meshes, seed=0, size=(160, 120)):
    """The same three objects in a JAX and a port Scene, both seeded, with
    the JAX package's default projection (the two packages' own defaults
    differ in the last bit: ``tan`` rounds differently)."""
    out = []
    for pkg, ms in ((jsl, meshes[0]), (sl, meshes[1])):  # meshes[2]: their directory
        scene = pkg.Scene(size)
        scene.seed(seed)
        for mesh in ms:
            scene.add_object(pkg.Object(mesh))
        out.append(scene)
    np.testing.assert_allclose(out[1].projection_matrix(), out[0].projection_matrix(), atol=1e-6)
    out[1].set_camera_projection(out[0].projection_matrix())
    return out


def _set_poses(scenes, poses):
    for scene in scenes:
        for o, T in zip(scene.objects, poses):
            o.set_pose(T)


def _contact_poses():
    """The cube on the sphere on the blob, each 2 mm into the next, tilted."""
    poses = []
    for i, (z, ang) in enumerate(((0.12, 0.0), (0.38, 0.3), (0.0, 0.2))):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(jm.rotation_x(jnp.float32(ang)))
        T[:3, 3] = (0.01 * i, 0.0, z)
        poses.append(T)
    return poses


def test_object_mass_properties_match_jax(meshes):
    """Mass, volume, inertia and inertial frame with the default density, a
    density and a mass override, 1e-5 relative."""
    js, ps = _scenes(meshes)
    _set_poses((js, ps), _contact_poses())
    for jo, po in zip(js.objects, ps.objects):
        for setup in (lambda o: None, lambda o: setattr(o, "density", 500.0),
                      lambda o: setattr(o, "mass", 0.7)):
            setup(jo)
            setup(po)
            for name in ("mass", "volume", "inertia", "inertial_frame"):
                np.testing.assert_allclose(getattr(po, name), getattr(jo, name), rtol=1e-5,
                                           atol=1e-7, err_msg=name)


def _filled(scenes):
    """Properties of every kind on both scenes."""
    _set_poses(scenes, _contact_poses())
    cam = np.asarray(jm.look_at(jnp.array([0.8, -0.6, 0.7]), jnp.zeros(3), jnp.array([0.0, 0, 1])))
    for i, scene in enumerate(scenes):
        scene.set_camera_pose(cam)
        scene.light_directions = np.array([[0.3, 0.2, -0.9], [-0.5, 0.1, -0.7]], np.float32)
        scene.light_colors = np.array([[2.0, 2.0, 1.5], [0.5, 0.5, 0.6]], np.float32)
        scene.ambient_light = np.array([0.1, 0.2, 0.3], np.float32)
        scene.background_plane_size = np.array([3.0, 2.0], np.float32)
        scene.manual_exposure = 1.5
        for j, o in enumerate(scene.objects):
            o.metallic, o.roughness = 0.25 * j, 0.5
            o.static = j == 2
            o.density = 800.0 + j
            o.casts_shadows = j != 1
            o.sticker_range = np.array([0.1, 0.2, 0.5, 0.25], np.float32)
            o.sticker_rotation = np.array([0.9238795, 0.3826834, 0.0, 0.0], np.float32)
            o.linear_velocity_limit = 2.5 if j == 0 else float("inf")
    return scenes


def _same_scene_state(a, b, atol=1e-6):
    np.testing.assert_allclose(a.camera_pose(), b.camera_pose(), atol=atol)
    np.testing.assert_allclose(a.projection_matrix(), b.projection_matrix(), atol=atol)
    for name in ("light_directions", "light_colors", "ambient_light", "background_plane_size",
                 "background_plane_pose"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), atol=atol, err_msg=name)
    assert a.viewport == b.viewport and a.manual_exposure == b.manual_exposure
    assert len(a.objects) == len(b.objects)
    for oa, ob in zip(a.objects, b.objects):
        np.testing.assert_allclose(oa.pose(), ob.pose(), atol=atol)
        for name in ("instance_index", "metallic", "roughness", "static", "density",
                     "casts_shadows", "linear_velocity_limit", "shininess"):
            assert getattr(oa, name) == getattr(ob, name), name
        for name in ("sticker_range", "sticker_rotation", "specular_color"):
            np.testing.assert_allclose(getattr(oa, name), getattr(ob, name), atol=atol)
        assert oa.mesh.filename == ob.mesh.filename
        assert oa.mesh.class_index == ob.mesh.class_index
        np.testing.assert_allclose(oa.mesh.pretransform, ob.mesh.pretransform, atol=atol)


@pytest.mark.parametrize("fmt", ["corrade", "json"])
def test_serialize_matches_jax(meshes, fmt, monkeypatch):
    """The same text from both packages; each deserializes the other's
    into the same state, which is the serialized one (JSON: exactly;
    Corrade text: 6 significant digits, within 1e-5, and what the JAX
    package's JSON leaves out, casts_shadows, at its default)."""
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", meshes[2] + "/mesh_cache")
    js, ps = _filled(_scenes(meshes))
    text_j, text_p = js.serialize(fmt), ps.serialize(fmt)
    assert text_p == text_j
    into_p, into_j = sl.Scene((8, 8)), jsl.Scene((8, 8))
    into_p.deserialize(text_j)
    into_j.deserialize(text_p)
    _same_scene_state(into_p, into_j)
    if fmt == "json":
        for o in ps.objects:
            o.casts_shadows = True
    _same_scene_state(into_p, ps, 1e-5 if fmt == "corrade" else 0.0)


def test_place_object_randomly_matches_jax(meshes):
    js, ps = _scenes(meshes, seed=12)
    for diameter, factor in ((0.3, 0.4), (0.15, 0.6), (0.5, 0.4)):
        want = js.place_object_randomly(diameter, factor)
        got = ps.place_object_randomly(diameter, factor)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[:3, 3], want[:3, 3])  # numpy draws: exact
    assert ps._rng.random() == js._rng.random()  # the streams stay in step


@pytest.mark.parametrize("sampler", ["random", "viewpoint", "view_corrected"])
def test_find_noncolliding_pose_matches_jax(meshes, sampler):
    """Each package moves the sphere next to the cube and blob until it
    overlaps neither: the same poses, the same answer, the same stream."""
    js, ps = _scenes(meshes, seed=21)
    far = _contact_poses()
    for T in far:
        T[:3, 3] += (0.0, 0.0, 1.0)  # cube and blob in view
    _set_poses((js, ps), far)
    kw = {"viewpoint": [0.0, 0.6, 0.8]} if sampler == "viewpoint" else {}
    if sampler == "view_corrected":
        kw["orientation"] = np.asarray(jm.rotation_x(jnp.float32(0.4)))
    for max_iter, factor in ((10, 0.4), (3, 0.7)):
        ok_j = js.find_noncolliding_pose(js.objects[1], sampler, max_iter, min_size_factor=factor,
                                         **kw)
        ok_p = ps.find_noncolliding_pose(ps.objects[1], sampler, max_iter, min_size_factor=factor,
                                         **kw)
        assert ok_p == ok_j
        np.testing.assert_allclose(ps.objects[1].pose(), js.objects[1].pose(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ps.objects[1].pose()[:3, 3], js.objects[1].pose()[:3, 3])
    assert ps._rng.random() == js._rng.random()


def test_check_collisions_matches_jax(meshes):
    js, ps = _scenes(meshes)
    poses = _contact_poses()
    for shift in (0.0, 0.05, 0.5):
        for T in poses[1:2]:
            T[2, 3] += shift
        _set_poses((js, ps), poses)
        assert ps.check_collisions() == js.check_collisions()
        assert [ps.is_object_colliding(o) for o in ps.objects] == ps.check_collisions()
    js.objects[0].set_pose(np.eye(4))
    ps.objects[0].set_pose(np.eye(4))
    assert ps.check_collisions() == js.check_collisions() and any(ps.check_collisions())


def _assert_objects_close(ps, js, atol):
    for po, jo in zip(ps.objects, js.objects):
        np.testing.assert_allclose(po.pose(), jo.pose(), rtol=0, atol=atol)
        np.testing.assert_allclose(po.linear_velocity, jo.linear_velocity, rtol=0, atol=atol)
        np.testing.assert_allclose(po.angular_velocity, jo.angular_velocity, rtol=0, atol=atol)


def test_simulate_one_step_matches_jax(meshes):
    """``simulate(0.002)`` on a pile in contact: poses and velocities 1e-5,
    the separations written back 1e-5."""
    js, ps = _scenes(meshes)
    _set_poses((js, ps), _contact_poses())
    for jo, po in zip(js.objects, ps.objects):
        jo.linear_velocity = po.linear_velocity = [0.1, -0.2, 0.05]
        jo.angular_velocity = po.angular_velocity = [0.5, 0.0, -0.3]
    js.simulate(0.002)
    ps.simulate(0.002)
    _assert_objects_close(ps, js, 1e-5)
    sep_j = np.array([o.separation for o in js.objects])
    sep_p = np.array([o.separation for o in ps.objects])
    assert (sep_j < 0).any()  # the pile is in contact
    np.testing.assert_allclose(sep_p, sep_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("call", ["simulate_steps", "run_substeps"])
def test_engine_loops_match_jax(meshes, call):
    """10 steps of ``simulate_steps`` (cold) and ``run_substeps`` (warm),
    on each scene's compiled state with the floor, 1e-4."""
    js, ps = _scenes(meshes)
    poses = _contact_poses()
    for T in poses:
        T[2, 3] += 0.045
    _set_poses((js, ps), poses)
    ja, jp, jpairs, _ = js._compile()
    pa, pp, ppairs, _ = ps._compile()
    jstate, pstate = js._state_from_objects(), ps._state_from_objects("cpu")
    jfloor, pfloor = js._default_floor(True), ps._default_floor(True)
    if call == "simulate_steps":
        sj, rj = jengine.simulate_steps(ja, jp, jstate, jfloor, jpairs, 0.005, 10, js._solver_cfg)
        sp, rp = engine.simulate_steps(pa, pp, pstate, pfloor, ppairs, 0.005, 10, ps._solver_cfg)
    else:
        sj, rj = jax.jit(jengine.run_substeps, static_argnums=(6, 7))(
            ja, jp, jstate, jfloor, jpairs, 0.04, 10, js._solver_cfg)
        sp, rp = engine.run_substeps(pa, pp, pstate, pfloor, ppairs, 0.04, 10, ps._solver_cfg)
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        np.testing.assert_allclose(getattr(sp, name)[0].numpy(), np.asarray(getattr(sj, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(rp.min_separation[0].numpy(), np.asarray(rj.min_separation),
                               rtol=0, atol=1e-4)


def _at_rest_on_floor(ps, scene):
    """Every body's lowest hull vertex on the floor and its COM at rest (as
    ``test_torch_physics.py`` holds the settle), on the port's hull atlas."""
    atlas, nb = ps._compile()[0], len(scene.objects)
    rot = np.stack([o.pose()[:3, :3] for o in scene.objects])
    state = make_empty_state(nb, device="cpu")._replace(
        pos=torch.from_numpy(np.stack([o.pose()[:3, 3] for o in scene.objects]))[None],
        quat=m.matrix_to_quat(torch.from_numpy(rot))[None])
    z = torch.where(atlas.vert_valid, world_hull_verts(atlas, state)[0, ..., 2], torch.inf)
    zmin = torch.full((nb,), torch.inf).scatter_reduce(0, atlas.hull_body.long(), z.amin(1), "amin")
    assert (zmin >= jtt.FLOOR_TOP_Z - 5e-3).all(), zmin
    lin = np.stack([o.linear_velocity for o in scene.objects])
    assert (np.linalg.norm(lin, axis=-1) < 1e-2).all(), lin


def test_simulate_tabletop_scene_matches_jax(meshes, monkeypatch):
    """The reference's 100 x 4 settle on both scenes from JAX's stack
    orientations: the same plane yaw (numpy stream), every body at rest on
    the floor in both; then the port's camera fit on JAX's settled poses
    from JAX's rotation equals JAX's camera, 1e-5. The port's ``vis_cb``
    path, from the same stack, sees 100 frames and comes to rest too."""
    js, ps = _scenes(meshes, seed=5)
    keys = {}

    def spy(name, fn):
        def wrapped(key, *args, **kwargs):
            keys[name] = key
            return fn(key, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(jtt, "simulate_tabletop", spy("stack", jtt.simulate_tabletop))
    monkeypatch.setattr(jscene_mod, "choose_random_camera_pose",
                        spy("camera", jscene_mod.choose_random_camera_pose))
    js.simulate_tabletop_scene()
    quats = np.asarray(jm.random_quaternion(keys["stack"], (len(js.objects),)))
    R = np.asarray(jfit.random_camera_rotation(keys["camera"]))
    ps._stack_quaternions = lambda n: torch.from_numpy(quats)[None]
    ps._camera_rotation = lambda: torch.from_numpy(R)[None]
    ps.simulate_tabletop_scene()
    np.testing.assert_allclose(ps.background_plane_pose, js.background_plane_pose, atol=1e-5)
    assert ps._rng.random() == js._rng.random()
    for scene in (js, ps):
        _at_rest_on_floor(ps, scene)
    for po, jo in zip(ps.objects, js.objects):
        po.set_pose(jo.pose())
    ps.choose_random_camera_pose()
    np.testing.assert_allclose(ps.camera_pose(), js.camera_pose(), rtol=0, atol=1e-5)
    frames = []
    ps.simulate_tabletop_scene(vis_cb=frames.append)
    assert frames == list(range(100))
    _at_rest_on_floor(ps, ps)
