"""The port imports neither jax nor the JAX package, nor an image or plot
library, nor the repository's ``bench.py`` or ``tools/``: a fresh
interpreter that refuses every ``jax``, ``jaxlib``, ``stillleben_tpu``,
``bench``, ``tools``, ``PIL``, ``cv2``, ``imageio`` and ``matplotlib`` module
(the port, ``stillleben_tpu_torch``, is another top-level name) imports the
whole port, loads meshes and their PNG texture from files through the port's own
``Mesh`` and codec (every mesh format, cooked by the port's native build),
reads a light map's descriptor and panorama, saves and loads images (PNG,
JPEG, BMP, TGA, TIFF, GIF, Netpbm; the WebP and other fixtures decoded),
builds a template with a background plane and a light map, renders a full
frame through each raster on the CPU, and streams a batch in the modes of
the tuned and reference-quality configurations, resolves every name of the
public table and draws the viewer's dashboard, also through its headless
``run``."""

import subprocess
import sys
import textwrap

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "stillleben_tpu", "bench", "tools", "PIL", "cv2", "imageio",
               "matplotlib")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    import torch
    import stillleben_tpu_torch
    names = set()
    for mod in pkgutil.walk_packages(stillleben_tpu_torch.__path__, "stillleben_tpu_torch."):
        importlib.import_module(mod.name)
        names.add(mod.name.removeprefix("stillleben_tpu_torch."))
    new = {"assets.image", "assets.texture", "render.light_map", "render.ibl", "render.ssao",
           "render.stages", "context", "core.quat", "scene.object", "scene.pose",
           "render.render_pass", "utils.corrade_config", "utils.sanitize", "diff", "losses",
           "camera_model", "annotate", "debug", "assets.gltf", "assets.primitive",
           "assets.fbxfile", "assets.legacy_formats", "assets.native_decompose",
           "assets.image_loader", "assets.image_saver", "assets.writers", "viewer",
           "viewer_web", "utils.arcball", "scene.animator", "scene.job_queue",
           "scene.manipulation_sim", "physics.telemetry", "profiling", "extension",
           "parallel.distributed", "assets.jpeg", "assets.bmp", "assets.tga", "assets.gif",
           "assets.tiff", "assets.native_image", "assets.native_build", "assets.image_fixtures",
           "assets.image_limits",
           "assets.image_fixtures.digests", "examples.pbr", "examples.viewer", "examples.ycb",
           "assets.webp", "assets.netpbm", "assets.qoi", "assets.sgi", "assets.pcx", "assets.im",
           "assets.dds", "tools", "tools.templates", "tools.settle_fidelity",
           "tools.display_mesh", "tools.viewer_demo", "tools.align_mesh"}
    assert new <= names, new - names

    from stillleben_tpu_torch.assets.mesh import Mesh
    from stillleben_tpu_torch.assets.procedural import checker_texture, sky_equirect, write_meshes
    from stillleben_tpu_torch.assets.texture import Texture2D
    from stillleben_tpu_torch.render.light_map import LightMap
    from stillleben_tpu_torch.parallel.batch import generate_batch, template_from_scene
    from stillleben_tpu_torch.physics.types import default_config
    from stillleben_tpu_torch.render.frame import FrameConfig
    from stillleben_tpu_torch.scene.scene import Object, Scene

    paths = write_meshes(sys.argv[1], subdiv=2)
    # every loader, the native cooker, the light map's files and the image
    # loader and saver, through the port's own codec
    from stillleben_tpu_torch.assets.procedural import write_loader_fixtures
    from stillleben_tpu_torch.render import light_map
    import stillleben_tpu_torch as sl
    fx = write_loader_fixtures(sys.argv[1] + "/fixtures", subdiv=2)
    loaded = Mesh.load_threaded([fx[k] for k in ("glb", "gltf", "fbx", "fbx_ascii", "3ds", "x",
                                                 "dae", "stl", "off")] + ["primitive://cube"])
    assert all(m.physics_mesh_data["volumes"].sum() > 0 for m in loaded)
    sky, lights = light_map._load_source(fx["ibl"])
    assert sky.shape == (64, 128, 3) and len(lights) == 1
    with sl.ImageSaver(num_threads=1) as saver:
        saver.save(np.zeros((4, 4, 4), np.uint8), sys.argv[1] + "/fixtures/saved.png")
        for ext in (".jpg", ".bmp", ".tga", ".tif", ".gif", ".ppm"):
            saver.save(np.full((4, 4, 3), 9, np.uint8), sys.argv[1] + "/fixtures/saved" + ext)
        saver.save(np.full((4, 4), 300, np.uint16), sys.argv[1] + "/fixtures/saved16.pgm")
    # the other image formats, through the port's native codec
    from stillleben_tpu_torch.assets import image, image_fixtures
    assert (image.read_image(sys.argv[1] + "/fixtures/saved.gif")[..., :3] == 9).all()
    assert (image.read_image_cv2(sys.argv[1] + "/fixtures/saved16.pgm") == 300).all()
    for name in image_fixtures.FILES:
        assert image.read_image(image_fixtures.path(name)).shape == (67, 91, 4), name
    for name in image_fixtures.WEBP_FILES:
        assert image.read_image(image_fixtures.path(name)).dtype == np.uint8, name
        assert image.read_image_cv2(image_fixtures.path(name)).shape[2] == 3, name
    import os
    plain = sys.argv[1] + "/plain"
    os.makedirs(plain)
    with sl.ImageSaver(num_threads=1) as saver:
        for ext in (".qoi", ".sgi", ".pcx", ".im", ".dds"):
            saver.save(np.full((4, 4, 3), 9, np.uint8), plain + "/saved" + ext)
    for ext in (".qoi", ".sgi", ".pcx", ".im", ".dds"):
        assert (image.read_image(plain + "/saved" + ext)[..., :3] == 9).all(), ext
    for name in image_fixtures.PLAIN_ENCODE_FILES + image_fixtures.PLAIN_READ_FILES:
        assert image.read_image(image_fixtures.path(name)).dtype == np.uint8, name
        assert image.read_image_cv2(image_fixtures.path(name)) is None, name
    loader = sl.ImageLoader(sys.argv[1] + "/fixtures", seed=0, num_threads=1)
    assert loader.next_texture().pixels.dtype == np.uint8
    loader.close()
    scene = Scene((32, 32))
    for name, diag in (("cube", 0.25), ("sphere", 0.3), ("blob_textured", 0.25)):
        flags = Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL if name == "blob_textured" else 0
        mesh = Mesh(paths[name], flags=flags)
        mesh.center_bbox()
        mesh.scale_to_bbox_diagonal(diag)
        scene.add_object(Object(mesh))
    scene.background_plane_size = np.array([3.0, 3.0], np.float32)
    scene.background_plane_texture = Texture2D(checker_texture(64))
    scene.light_map = LightMap.from_equirect(sky_equirect(8, 16), device="cpu")
    tpl = template_from_scene(scene, "cpu")
    assert (tpl.render_atlas.mat_base_tex >= 0).sum() == 2 and tpl.light_map is not None
    for raster in ("cells", "classic"):
        cfg = FrameConfig(width=32, height=32, max_lights=1, shadow_size=32, raster=raster)
        frames = generate_batch(torch.Generator().manual_seed(1), 1, tpl, cfg, default_config(),
                                settle_iterations=1)
        assert frames.valid.any() and (frames.hdr[..., 3] > 0.9999).all(), raster
    # the modes of the tuned and reference-quality configurations, and the stream
    from stillleben_tpu_torch.parallel.batch import generate_stream
    tuned = FrameConfig(width=32, height=32, max_lights=1, shadow_size=32, backface_cull=True,
                        shadow_cull=True, vsm_taps=1, ibl_prefilter="nearest", ibl_sh=False)
    solver = default_config()._replace(contact_gen="frame", sleep_frames=2)
    for b in generate_stream(tpl, tuned, solver, batch=1, n_batches=1, seed=2,
                             gt_fields=("rgb", "depth"), settle_iterations=3):
        assert b["depth"].dtype.name == "float16" and b["rgb"].shape == (1, 32, 32, 4)
    ref = tuned._replace(shadow_mode="pcf", shading="phong", ssao_mode="reference", max_lights=3)
    frames = generate_batch(torch.Generator().manual_seed(1), 1, tpl, ref,
                            default_config()._replace(contact_gen="every2"), settle_iterations=1)
    assert frames.valid.any()
    # one refinement step through render_with_poses under autograd, then the
    # reference's approximate route on the same frame
    from stillleben_tpu_torch import camera_model, diff, losses
    from stillleben_tpu_torch.parallel.batch import (
        apply_pose_delta_matrix, render_with_poses, settle_scene)
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(1), 1, tpl, default_config(),
                                       settle_iterations=1)
    delta = torch.full((poses.shape[1], 6), 0.01, requires_grad=True)
    f = render_with_poses(tpl, apply_pose_delta_matrix(poses[0], delta), cams[0], cfg, lights[0])
    f.hdr[..., :3].square().mean().backward()
    assert torch.isfinite(delta.grad).all() and delta.grad.abs().max() > 0
    loss, img = losses.neg_iou_loss(f.hdr[None, ..., :3].permute(0, 3, 1, 2).detach(),
                                    torch.ones(1, 3, 32, 32))
    assert torch.isfinite(loss) and camera_model.blur(img[0], 1.0).shape == (3, 32, 32)
    # the whole public table, and the viewer's dashboard and headless run
    for name in ("Viewer", "view", "JobQueue", "ManipulationSim", "Animator", "profiling",
                 "extension"):
        getattr(sl, name)
    sl.init(device="cpu")
    viewer = sl.Viewer(scene)
    img = viewer.dashboard()
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8 and img.any()
    import os
    os.environ.pop("DISPLAY", None)
    viewer.run(sys.argv[1] + "/dashboard.png")
    from stillleben_tpu_torch.assets.image import read_png_samples
    assert (read_png_samples(sys.argv[1] + "/dashboard.png").samples.reshape(img.shape) == img).all()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("OK")
    """
)


def test_port_runs_without_jax(tmp_path):
    # one torch thread: the test runs beside other pytest-xdist workers
    env_cache = {"STILLLEBEN_TPU_MESH_CACHE": str(tmp_path / "mesh_cache"), "OMP_NUM_THREADS": "1"}
    import os

    env = dict(os.environ, **env_cache)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
