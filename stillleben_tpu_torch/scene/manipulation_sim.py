"""Cartesian-impedance manipulation ("robot pushes things").

Counterpart of ``stillleben_tpu/scene/manipulation_sim.py``. Reference
src/manipulation_sim.cpp:28-93: a PxD6Joint from a world anchor to the
manipulator object with translation free / rotation locked and a spring
drive (stiffness 600 N/m, damping 0.1, force limit 60 N); ``step(goal, dt)``
sets the drive target and steps the scene.

The joint is a SOLVER-level constraint here, not a kinematic overwrite: the
rotation lock zeroes the manipulator's inverse inertia (an infinitely stiff
angular constraint: contact impulses cannot rotate the manipulator, while
reaction forces/torques still propagate exactly to the bodies it pushes,
matching the D6 joint's momentum bookkeeping), and the spring drive is a
clamped external force applied before the contact solve. The scene steps
on the context's device.
"""

from __future__ import annotations

import numpy as np

STIFFNESS = 600.0  # N/m (reference manipulation_sim.cpp:52)
DAMPING = 0.1
FORCE_LIMIT = 60.0  # N


class ManipulationSim:
    def __init__(self, scene, manipulator, initial_pose=None):
        self._scene = scene
        self._obj = manipulator
        if initial_pose is not None:
            manipulator.set_pose(np.asarray(initial_pose, np.float32))
        # rotation-locked D6 joint: angular DOFs are rigid at the solver
        # level (Object.lock_rotation zeroes the body's inverse inertia;
        # the scene's compile stamp holds the flag, and the compiled body
        # set is dropped here as well)
        manipulator.lock_rotation = True
        scene._invalidate()

    def step(self, goal_pose, dt: float) -> None:
        goal_pose = np.asarray(goal_pose, np.float32).reshape(4, 4)
        pose = self._obj.pose()
        mass = max(self._obj.mass, 1e-6)

        # spring drive toward the goal position (clamped to the force limit,
        # reference PxD6JointDrive(600, 0.1, 60))
        err = goal_pose[:3, 3] - pose[:3, 3]
        vel = self._obj.linear_velocity
        force = STIFFNESS * err - DAMPING * vel
        norm = float(np.linalg.norm(force))
        if norm > FORCE_LIMIT:
            force *= FORCE_LIMIT / norm
        self._obj.linear_velocity = vel + force / mass * dt

        # the contact solve handles the rotation lock; no pose overwrite
        self._scene.simulate(dt)
