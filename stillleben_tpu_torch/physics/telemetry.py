"""Physics telemetry recorder, the analogue of PhysX Visual Debugger
streaming (the reference connects PVD when available,
src/context.cpp:224-234: rigid-body transforms + contact data streamed to an
inspection tool).

Counterpart of ``stillleben_tpu/physics/telemetry.py``: numpy over the
host API of the port's ``Object`` (poses, velocities, ``separation``), the
quaternions (w, x, y, z) from the port's torch math on the CPU.

Streaming happens at the frame boundary: :class:`PhysicsTelemetry` rides
the existing per-iteration
callback path (``scene.simulate_tabletop_scene(vis_cb=tele.vis_cb(scene))``)
or explicit ``record(scene)`` calls around ``scene.simulate(dt)``, capturing
per-body poses, velocities, contact separations and derived aggregates
(kinetic energy, resting fraction, redrop teleports). Records export as
JSONL for offline inspection and replay through the scriptable Viewer.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core import math as m

# a body teleporting up by more than this between frames is a redrop
# (tabletop.py _redrop respawns above the stack)
_REDROP_JUMP_Z = 0.25


class PhysicsTelemetry:
    """Frame-by-frame recorder over live Scene objects."""

    def __init__(self):
        self.frames: list[dict] = []
        self._prev_z: np.ndarray | None = None

    # -- capture ---------------------------------------------------------

    def record(self, scene, iteration: int | None = None) -> dict:
        """Capture one frame from the scene's current object states."""
        pos, quat, lin, ang, sep = [], [], [], [], []
        for o in scene.objects:
            T = o.pose()
            pos.append(np.asarray(T[:3, 3], np.float64))
            R = torch.from_numpy(np.ascontiguousarray(T[:3, :3], np.float32))
            quat.append(m.matrix_to_quat(R).numpy().astype(np.float64))
            lin.append(np.asarray(o.linear_velocity, np.float64))
            ang.append(np.asarray(o.angular_velocity, np.float64))
            sep.append(float(getattr(o, "separation", np.inf)))
        pos = np.array(pos).reshape(-1, 3)
        lin = np.array(lin).reshape(-1, 3)
        ang = np.array(ang).reshape(-1, 3)
        sep = np.array(sep)

        speed = np.linalg.norm(lin, axis=-1) if len(pos) else np.zeros(0)
        spin = np.linalg.norm(ang, axis=-1) if len(pos) else np.zeros(0)
        # unit-mass kinetic proxy (hull masses live in the solver's params;
        # the telemetry rides the scene API, which is mass-agnostic)
        kinetic = float(0.5 * (speed**2).sum() + 0.5 * (spin**2).sum())
        resting = bool(len(pos)) and bool(
            np.all(speed < 0.05) and np.all(spin < 0.5)
        )
        redrops = 0
        if self._prev_z is not None and len(pos) == len(self._prev_z):
            redrops = int(((pos[:, 2] - self._prev_z) > _REDROP_JUMP_Z).sum())
        self._prev_z = pos[:, 2].copy() if len(pos) else None

        frame = {
            "frame": len(self.frames) if iteration is None else int(iteration),
            "bodies": [
                {
                    "pos": [round(float(v), 6) for v in pos[i]],
                    "quat": [round(float(v), 6) for v in quat[i]],
                    "lin_vel": [round(float(v), 6) for v in lin[i]],
                    "ang_vel": [round(float(v), 6) for v in ang[i]],
                    "separation": (
                        None if not np.isfinite(sep[i]) else round(sep[i], 6)
                    ),
                }
                for i in range(len(pos))
            ],
            "kinetic": round(kinetic, 9),
            "min_separation": (
                None if not np.isfinite(sep).any()
                else round(float(np.nanmin(np.where(np.isfinite(sep), sep,
                                                    np.nan))), 6)
            ),
            "resting": resting,
            "redrops": redrops,
        }
        self.frames.append(frame)
        return frame

    def vis_cb(self, scene):
        """Adapter for ``simulate_tabletop_scene(vis_cb=...)`` — records the
        scene at every settle iteration (poses are written back first)."""

        def cb(i):
            self.record(scene, iteration=i)

        return cb

    # -- analysis / export -------------------------------------------------

    def summary(self) -> dict:
        """Settle-quality aggregates over the recording."""
        if not self.frames:
            return {"frames": 0}
        kin = [f["kinetic"] for f in self.frames]
        seps = [
            f["min_separation"] for f in self.frames
            if f["min_separation"] is not None
        ]
        return {
            "frames": len(self.frames),
            "bodies": len(self.frames[-1]["bodies"]),
            "kinetic_first": kin[0],
            "kinetic_last": kin[-1],
            "max_penetration": (
                round(-min(seps), 6) if seps and min(seps) < 0 else 0.0
            ),
            "total_redrops": int(sum(f["redrops"] for f in self.frames)),
            "resting_at_end": bool(self.frames[-1]["resting"]),
        }

    def save(self, path: str) -> str:
        """One JSON line per frame, then a summary line (PVD capture file)."""
        with open(path, "w") as f:
            for frame in self.frames:
                f.write(json.dumps(frame) + "\n")
            f.write(json.dumps({"summary": self.summary()}) + "\n")
        return path

    @staticmethod
    def load(path: str) -> tuple[list[dict], dict]:
        """Returns (frames, summary) from a saved capture."""
        frames, summary = [], {}
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "summary" in rec:
                    summary = rec["summary"]
                else:
                    frames.append(rec)
        return frames, summary

    def replay(self, scene, frame: int) -> None:
        """Write a recorded frame's poses back into a scene (inspection in
        the Viewer: step through a capture like PVD's timeline)."""
        rec = self.frames[frame]
        for o, b in zip(scene.objects, rec["bodies"]):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = m.quat_to_matrix(torch.tensor(b["quat"], dtype=torch.float32)).numpy()
            T[:3, 3] = b["pos"]
            o.set_pose(T)
