"""stillleben_tpu_torch: ``stillleben_tpu`` in PyTorch, for NVIDIA Hopper GPUs.

The package imports torch and numpy, never jax and nothing of
``stillleben_tpu``. It has its own host asset layer (``assets/``: glTF/GLB,
OBJ, PLY, STL, OFF, DAE, FBX, 3DS and .x import, ``primitive://``
meshes, consolidation, native and Python convex cooking, decimation, its
own image codec (PNG, PPM, Radiance HDR, and JPEG, BMP, TGA, GIF and TIFF
over the native ``csrc/sl_image.cpp``), ``ImageLoader`` and ``ImageSaver``;
``physics/bodies``: mass properties). Every TPU kernel of the JAX package is a CUDA kernel here
(``csrc/``, wrapped by ``ops/``): the compact-cell z-buffer of the default
raster, the fine z-buffer of the classic raster
(``FrameConfig(raster="classic")``) and the toolchain check.

The public API is the JAX package's (reference python/stillleben/__init__.py):

    import stillleben_tpu_torch as sl
    sl.init()                      # cuda:0; init(device="cpu") for the CPU
    mesh = sl.Mesh("cube.obj")
    scene = sl.Scene((640, 480))
    scene.add_object(sl.Object(mesh))
    scene.simulate_tabletop_scene()
    result = sl.RenderPass().render(scene)
    rgb = result.rgb()             # (480, 640, 4) uint8 tensor on the card

The batched datagen entry point is ``parallel.batch.generate_batch``.
Render-and-compare pose refinement differentiates
``parallel.batch.render_with_poses`` with autograd, or chains image
gradients to poses with ``sl.diff`` (the reference's approximate module).
The rest of the reference's table is here too: ``Viewer`` / ``view`` (and
the web viewer), ``JobQueue``, ``ManipulationSim``, ``Animator``,
``profiling`` and ``extension``; the name table equals the JAX package's.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

# name -> (module, attribute), resolved on first use
_LAZY = {
    "init": (".context", "init"),
    "init_cuda": (".context", "init_cuda"),
    "context": (".context", "context"),
    "Context": (".context", "Context"),
    "Mesh": (".assets.mesh", "Mesh"),
    "MeshCache": (".assets.mesh", "MeshCache"),
    "Object": (".scene.object", "Object"),
    "Scene": (".scene.scene", "Scene"),
    "RenderPass": (".render.render_pass", "RenderPass"),
    "RenderPassResult": (".render.render_pass", "RenderPassResult"),
    "LightMap": (".render.light_map", "LightMap"),
    "Texture": (".assets.texture", "Texture"),
    "Texture2D": (".assets.texture", "Texture2D"),
    "ImageLoader": (".assets.image_loader", "ImageLoader"),
    "ImageSaver": (".assets.image_saver", "ImageSaver"),
    "Animator": (".scene.animator", "Animator"),
    "JobQueue": (".scene.job_queue", "JobQueue"),
    "ManipulationSim": (".scene.manipulation_sim", "ManipulationSim"),
    "Range3D": (".core.range3d", "Range3D"),
    "quat_to_matrix": (".core.quat", "quat_to_matrix"),
    "matrix_to_quat": (".core.quat", "matrix_to_quat"),
    "view": (".viewer", "view"),
    "Viewer": (".viewer", "Viewer"),
    "generate_stream": (".parallel.batch", "generate_stream"),
    "render_debug_image": (".debug", "render_debug_image"),
    "object_annotations": (".annotate", "object_annotations"),
    # submodules exposed as attributes
    "camera_model": (".camera_model", None),
    "diff": (".diff", None),
    "losses": (".losses", None),
    "profiling": (".profiling", None),
    "extension": (".extension", None),
}

# names of the JAX package's table (stillleben_tpu/__init__.py:31-64) that
# are not ported yet: none
NOT_PORTED = ()

__all__ = sorted(_LAZY)

# Importing the submodule ``context`` binds that name on the package to the
# module; the public name is the function, as in the reference. Bind it
# now, before any other module imports the submodule.
from . import context as _context_module  # noqa: E402

context = _context_module.context


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod_name, attr = _LAZY[name]
    module = importlib.import_module(mod_name, __name__)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value
    return value


def __dir__():
    return __all__
