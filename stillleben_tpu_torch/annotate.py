"""Per-object dataset annotations from a rendered result.

Counterpart of ``stillleben_tpu/annotate.py``. Pose-estimation datasets
(YCB-Video, the BOP family) need per object the camera-frame pose, the 2-D
bounding box, the visible pixel count and the occlusion-aware visibility
fraction (BOP's ``visib_fract`` = visible px / unoccluded px). All of it
comes from the buffers the renderer already makes; the unoccluded count
from one flat re-render per object with the draw predicate isolating it
(``RenderPass.render(predicate=...)``, so the cell raster again).
"""

from __future__ import annotations

import numpy as np

__all__ = ["object_annotations"]


def _mask_bbox(mask: np.ndarray):
    """Tight [x, y, w, h] of a boolean mask, or None when it is empty."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return None
    return [int(xs.min()), int(ys.min()),
            int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]


def _instance_map(result) -> np.ndarray:
    inst = result.instance_index()
    return np.asarray(inst.cpu().numpy() if hasattr(inst, "cpu") else inst).astype(np.int32)


def object_annotations(scene, result, compute_visibility: bool = True):
    """List of per-object annotation dicts for one rendered ``result``.

    Keys: ``instance_index``, ``class_index``, ``pose`` (object -> world
    4x4), ``cam_pose`` (object -> camera 4x4), ``bbox`` ([x, y, w, h] of the
    visible mask, None when fully occluded or out of frame),
    ``px_count_visib``, and with ``compute_visibility`` ``px_count_all``
    (the unoccluded solo render) and ``visib_fract``. Host values (numpy
    and Python numbers), as the JAX package returns them.
    """
    inst = _instance_map(result)
    world_to_cam = np.linalg.inv(np.asarray(scene.camera_pose()))

    solo_masks = {}
    if compute_visibility:
        from .render.render_pass import RenderPass

        rp = RenderPass(shading="flat", ssao=False)
        for o in scene.objects:
            solo = rp.render(scene, predicate=lambda x, o=o: x is o)
            solo_masks[o.instance_index] = _instance_map(solo) == o.instance_index

    out = []
    for o in scene.objects:
        idx = o.instance_index
        pose = np.asarray(o.pose())
        visible = inst == idx
        n_vis = int(visible.sum())
        ann = {
            "instance_index": int(idx),
            "class_index": int(o.mesh.class_index),
            "pose": pose,
            "cam_pose": world_to_cam @ pose,
            "bbox": _mask_bbox(visible),
            "px_count_visib": n_vis,
        }
        if compute_visibility:
            n_all = int(solo_masks[idx].sum())
            ann["px_count_all"] = n_all
            ann["visib_fract"] = (n_vis / n_all) if n_all else 0.0
        out.append(ann)
    return out
