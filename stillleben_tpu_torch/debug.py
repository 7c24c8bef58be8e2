"""Debug visualization: the render with each object's coordinate axes
drawn over it.

Counterpart of ``stillleben_tpu/debug.py`` (reference src/debug.cpp:20-59,
``renderDebugImage``).
"""

from __future__ import annotations

import numpy as np
import torch


def _draw_line(img: np.ndarray, p0, p1, color):
    """DDA line from p0 to p1 into an (H, W, C) uint8 image, clipped."""
    H, W = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    t = np.linspace(0.0, 1.0, n + 1)
    x = np.rint(x0 + (x1 - x0) * t).astype(np.int64)
    y = np.rint(y0 + (y1 - y0) * t).astype(np.int64)
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    img[y[ok], x[ok], :3] = color


def render_debug_image(scene) -> torch.Tensor:
    """Render the scene (``RenderPass(ssao=False)``) and draw each object's
    x, y and z axes in red, green and blue, 0.3 of its bounding-box
    diagonal long. Returns an (H, W, 4) uint8 tensor on the render's
    device."""
    from .render.camera import project_points
    from .render.render_pass import RenderPass

    res = RenderPass(ssao=False).render(scene)
    rgb = res.rgb()
    img = rgb.cpu().numpy().copy()
    W, H = scene.viewport
    P = torch.from_numpy(np.asarray(scene.projection_matrix(), np.float32))
    world_to_cam = np.linalg.inv(scene.camera_pose())

    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]  # x, y, z axes
    for obj in scene.objects:
        T = obj.pose()
        scale = obj.mesh.bbox.diagonal * 0.3
        origin = T[:3, 3]
        pts_world = [origin] + [origin + T[:3, k] * scale for k in range(3)]
        pts_cam = np.stack([world_to_cam[:3, :3] @ p + world_to_cam[:3, 3] for p in pts_world])
        u, v, w = (x.numpy() for x in
                   project_points(P, torch.from_numpy(pts_cam.astype(np.float32)), W, H))
        if w[0] <= 0:
            continue
        for k in range(3):
            if w[k + 1] > 0:
                _draw_line(img, (u[0], v[0]), (u[k + 1], v[k + 1]), colors[k])
    return torch.from_numpy(img).to(rgb.device)
