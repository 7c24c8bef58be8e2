"""YCB-Video-style synthetic scene generation (counterpart of ``examples/ycb.py``).

Generates scenes with composition similar to the YCB Video Dataset (Xiang
et al. 2017, PoseCNN, arXiv:1711.00199). Point it at a YCB models
directory; without one it falls back to built-in primitives so the example
always runs. ``run`` writes one RGB JPEG; ``run_stream`` (``--stream N``)
streams batches of 8 scenes and writes each scene's RGB as PNG and JPEG and
its instance mask as 16-bit PNG through the port's ``ImageSaver``.

    python -m stillleben_tpu_torch.examples.ycb [PATH] [--device cpu] [--stream N]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import random

import numpy as np

CLASSES = (
    "__background__",
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser",
    "024_bowl", "025_mug", "035_power_drill", "036_wood_block",
    "037_scissors", "040_large_marker", "051_large_clamp",
    "052_extra_large_clamp", "061_foam_brick",
)
RESOLUTION = (640, 480)
INTRINSICS = (1066.778, 1067.487, 312.9869, 241.3109)


def _primitives(sl):
    meshes = []
    for i, (name, diag) in enumerate((("cube", 0.15), ("sphere", 0.12))):
        m = sl.Mesh(f"primitive://{name}")
        m.scale_to_bbox_diagonal(diag)
        m.class_index = i + 1
        meshes.append(m)
    return meshes


def run(ycb_path=None, ibl_path=None, plane_texture_path=None, out="rgb.jpeg",
        device: str = "cuda", objects: int = 10, resolution=RESOLUTION) -> str:
    """One scene of ``objects`` random meshes, settled, lit and rendered;
    its RGB written to ``out`` (JPEG). Returns ``out``."""
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.jpeg import encode_jpeg

    sl.init(device=device)
    rng = random.Random(0)

    if ycb_path:
        mesh_path = pathlib.Path(ycb_path) / "models"
        meshes = sl.Mesh.load_threaded([mesh_path / c / "textured.obj" for c in CLASSES[1:]])
        for i, mesh in enumerate(meshes):
            mesh.class_index = i + 1
    else:
        print("No YCB dataset given — using built-in primitives.")
        meshes = _primitives(sl)

    scene = sl.Scene(tuple(resolution))
    scene.seed(0)
    scene.set_camera_intrinsics(*(v * resolution[0] / RESOLUTION[0] for v in INTRINSICS))

    for mesh in [rng.choice(meshes) for _ in range(objects)]:
        obj = sl.Object(mesh)
        # override metallic/roughness so it gets interesting
        obj.metallic = rng.random()
        obj.roughness = rng.random()
        scene.add_object(obj)

    # let them fall in a heap
    scene.simulate_tabletop_scene()

    # lighting
    if ibl_path:
        scene.light_map = sl.LightMap(str(ibl_path), device=device)
    else:
        scene.choose_random_light_position()

    # plane & background color
    scene.background_plane_size = np.array([3.0, 3.0])
    scene.background_color = np.array([0.1, 0.1, 0.1, 1.0])
    if plane_texture_path:
        scene.background_plane_texture = sl.Texture2D(plane_texture_path)

    if os.environ.get("DISPLAY"):
        sl.view(scene)

    result = sl.RenderPass().render(scene)
    with open(out, "wb") as f:
        f.write(encode_jpeg(result.rgb()[..., :3].cpu().numpy()))
    print(f"wrote {out}; instances visible:",
          sorted(set(np.unique(result.instance_index().cpu().numpy()).tolist()) - {0}))
    return out


def run_stream(n_batches=4, batch=8, out_dir="ycb_out", width=320, height=240,
               device: str = "cuda", shadow_size: int = 2048,
               settle_iterations: int | None = None) -> list[str]:
    """Production-shaped datagen: the host-pipelined stream renders batches
    on the device while the threaded saver writes the previous batch's
    images (RGB as PNG and JPEG, the instance mask as 16-bit PNG). Returns
    the paths written."""
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.parallel.batch import template_from_scene
    from stillleben_tpu_torch.physics import tabletop
    from stillleben_tpu_torch.physics.types import default_config
    from stillleben_tpu_torch.render.frame import FrameConfig

    sl.init(device=device)
    scene = sl.Scene((width, height))
    scene.seed(0)
    meshes = _primitives(sl)
    for k in range(8):
        scene.add_object(sl.Object(meshes[k % 2]))
    tpl = template_from_scene(scene, device)
    cfg = FrameConfig(width=width, height=height, shading="pbr", ssao=False, max_lights=1,
                      shadow_size=shadow_size)

    os.makedirs(out_dir, exist_ok=True)
    n, written = 0, []
    stream = sl.generate_stream(tpl, cfg, default_config(), batch=batch, n_batches=n_batches,
                                seed=0, settle_iterations=settle_iterations
                                or tabletop.MAX_ITERATIONS)
    with sl.ImageSaver() as saver:
        for frames in stream:
            for rgb, inst in zip(frames.rgb, frames.instance_index):
                for name, img in ((f"{n:06d}_rgb.png", rgb), (f"{n:06d}_rgb.jpg", rgb[..., :3]),
                                  (f"{n:06d}_mask.png", inst.astype(np.uint16))):
                    saver.save(img, os.path.join(out_dir, name))
                    written.append(os.path.join(out_dir, name))
                n += 1
    print(f"wrote {n} scenes to {out_dir}/")
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", metavar="PATH", type=str, nargs="?", default=None,
                        help='path containing the "models" directory (optional)')
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ibl", metavar="FILE.IBL", type=str, help="environment light map")
    parser.add_argument("--plane-texture", metavar="IMAGE", type=str)
    parser.add_argument("--out", default="rgb.jpeg")
    parser.add_argument("--stream", metavar="N", type=int, default=None,
                        help="datagen mode: stream N batches of 8 scenes to --out-dir")
    parser.add_argument("--out-dir", default="ycb_out")
    args = parser.parse_args(argv)
    if args.stream:
        return run_stream(n_batches=args.stream, out_dir=args.out_dir, device=args.device)
    return run(args.dataset, args.ibl, args.plane_texture, args.out, device=args.device)


if __name__ == "__main__":
    main()
