#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the datagen main path at
the benchmark's size, in every configuration that the JAX package's
``bench.py`` runs, through every hand-written kernel, on both rasters, the
public host API (``Scene`` -> ``simulate_tabletop_scene`` ->
``RenderPass().render``), render-and-compare pose refinement (autograd
through ``render_with_poses``, and ``sl.diff``) and the reference's asset
and light-map loaders (every mesh format, the native hull cooker,
``sl.LightMap`` from an sIBL descriptor, ``ImageSaver`` / ``ImageLoader``)
and the rest of the public table (``Viewer`` and its web front-end,
``JobQueue``, ``ManipulationSim`` with telemetry, ``profiling``,
``extension``, the sanitizers), the scale-out layer (a sharded batch
on a one-card mesh, two processes of one ``gloo`` group on the card, the
atlas modes, the classic raster's scan rule), the image formats (JPEG,
BMP, TGA, GIF, TIFF through the native codec; the ``ycb`` example), WebP
(the native decoder and encoder), GIF and Netpbm encoding, QOI, SGI, PCX,
IM and DDS both ways, the JPEG variants (arithmetic, lossless, CMYK/YCCK,
block-smoothed) and the repository's tools that are not TPU-only.

    python3 chip_smoke.py

Two configurations of the same 10 objects at 640x480: **bench-full** (the
JAX package's bench workload "textured": the dense mesh with its
base-colour texture, a 3 x 3 m checker background plane, the sky light map
with skybox, SSAO, trilinear textures, 2048^2 VSM shadow) and
**bench-slice** (the untextured configuration of the earlier slices: no
plane, light map, textures or SSAO). On bench-full, the two rungs of
``bench.py``: **tuned** (``TUNED.json``: back-face cull, 1-tap VSM, nearest
prefiltered level, the frame contact cadence with 128 narrowphase pairs
and the sleep exit, B = 16) and **refmode** (reference quality: PCF, the
reference SSAO, 3 shadowed light slots, the substep cadence, B = 8).

Phases (one line each or more; any failure exits non-zero):

1. device: the card's name, count and power limit; TF32 off.
2. build: one nvcc per ``stillleben_tpu_torch/csrc/*.cu`` source, all at
   once, for sm_90a (ptxas reports printed).
3. toolchain: the ``o = 2x`` kernel (K4) on an (8, 128) tensor, exact,
   timed beside an empty kernel's launch, the bound of a kernel that small.
4. light map, scene, settle: the sky's precompute on the card, once; both
   templates; one settle of B = 8 scenes, whose poses serve the kernel
   captures and the per-render breakdowns.
5. kernels: each raster kernel against its plain PyTorch version on the
   inputs one render of each configuration really produces: the cell
   kernel (K1, cells to tiles, the merge included) at the camera (tile 16)
   and 2048^2 shadow (tile 32) shapes, the classic fine kernel (K2) at the
   camera (tile 16) and shadow (tile 64) shapes, and K3 (4 and 8 tiles per
   occupancy block) on K2's inputs of both configurations, against the
   plain version and K2; all ``torch.equal``; each timed warm with CUDA
   events beside its bound (bytes, or the operations this input needs:
   ``needed_ops``), on inputs that leave only its fixed costs and with
   only its heaviest cell or tile (K3 in turns with K2: K2, K3, K3, K2).
   Then the torch stages that the kernels' row gathers and merge
   replace.
6. main path: ``generate_batch`` B = 8 of bench-full through the cell
   raster, first and warm call; content checks (finite, object pixels, the
   plane's pixels valid with class and instance 0, the skybox behind);
   K1's launch counts and no call of its plain version; scenes/s.
7. bench-slice: ``generate_batch`` B = 2 with 25 settle frames (cut from
   B = 8 and 100 frames to leave time for phase 10) through each raster;
   the same checks; K1's and K2's launch counts; scenes/s.
8. breakdown: the 8 settled poses rendered with both rasters in both
   configurations (ms per render; classic against cells per scene, split
   into the classic raster's holes and every other disagreement, which
   must stay under 3%); bench-full against bench-slice and against itself
   with textures, light map or SSAO off (each must change the image); the
   device time of one bench-full render by stage (CUDA events at the
   render's stage marks); K3's frames (4 and 8 tiles) bitwise equal to
   K2's in both configurations.
9. extras, one scene at 640x480: stickers on two objects (pixels change
   inside the stickers' range and nowhere else), the anisotropic and
   bilinear filters, the reference SSAO, the alpha peel on the cutout
   texture (K1's second camera pass takes the depth-peel floor and equals
   its plain version; discarded pixels show a deeper surface), a
   background image.
10. rungs: ``generate_batch`` of tuned (B = 16) and refmode (B = 8), first
    call each, with their settle seconds and each scene's stop frame, the
    content checks of phase 6, K1's launches (1 and 3 shadow passes per
    scene) and no plain version called; ``generate_stream`` of 3 tuned
    batches, 2 ahead, the training fields narrowed on the card (steady
    scenes/s; one batch's narrowing and copy timed alone); refmode's render
    by stage; K1 against its plain version on the tuned camera raster (back
    faces culled) and on each of refmode's 3 PCF shadow passes, K2 on a
    classic render with both culls (and its launches over 8 such renders);
    one render each with the shadow off, flat and phong (phong's frame
    equal to pbr's).
11. card against CPU: the small full scene at 160x120 rendered by the port
    on both devices in the bench-full, tuned and refmode frame
    configurations, by the rules of ``tests/test_torch_gpu.py``.
12. reference: on the CPU tests' small scene at 160x120, the instance map
    of each raster against the brute-force oracle's (cells >= 99.9%,
    classic >= 97%, the JAX package's own bound for its classic path).
13. api: the public host API on the card (``sl.init()``), bench-full's
    objects, sky and plane built through ``sl.Mesh``/``sl.Object``/
    ``sl.Scene`` at 640x480 on two seeds: ``simulate_tabletop_scene()``
    (the reference's 100 x 4 substeps, one scene), ``RenderPass().render``
    (first and warm), a ``depth_peel`` pass and a ``supersample=2`` render;
    the seconds per settle and ms per render, K1's launches per render
    (camera, shadow, peel; the light map's sun takes the free slot 1, so
    two shadow passes, slot 0 dark) and no call of its plain pieces; every
    accessor's shape and dtype, every field finite, objects and plane in
    view, the peel deeper, each object covering pixels when drawn alone
    (``predicate``); K1 ``torch.equal`` to its plain version on this path's
    camera, both shadow slots and the peel pass.
14. refine: render-and-compare pose refinement, no new settle. The
    trainer: ``render_with_poses`` of bench-full's template under autograd
    at phase 4's settled scene 0 (640x480, 2048^2 VSM, fast SSAO,
    textures, light map, plane), the target its frame at the settled
    poses; from delta = 0.02 on every pose parameter, 10 steps of
    ``make_train_step``'s loss and update (mean((hdr - target)^2) + 1e-6
    |delta|^2, delta -= 0.1 grad): ms per step (forward, backward; the
    first apart), the loss per step, the peak of
    ``torch.cuda.max_memory_allocated``, K1's launches per step (one camera
    and one shadow pass per forward, none in the backward) and no call of
    its plain pieces, and one more backward under ``torch.profiler`` (its
    kernels' device time and busy share, the kernels and ops with the most
    device time); it fails on a gradient that is not finite, on an
    object in view with an all-zero gradient, or when a step of 1e-3 along
    -grad (unit norm) does not lower the loss of step 0. The card against
    the CPU: d loss / d delta on phase 11's small full scene within 2e-2
    of each object's largest component (``tests/test_torch_gpu.py::
    compare_gradients``). The reference route: ``sl.diff`` on phase 13's
    first API scene with ambient light only and exposure 1 (as
    tests/test_diff.py): the 6-direction test on its textured dense mesh
    with the most pixels (every component must be positive; the JAX
    package gets all six on the CPU tests' fixture),
    ``bp_to_vertices_and_colors``, ``soft_forward`` over a 2-layer depth
    peel with ``neg_iou_loss``, ms per call. K1 ``torch.equal`` to its
    plain version on the trainer's camera and shadow inputs and on the
    peel pass.
15. loaders: ``write_loader_fixtures`` (the textured 81,920-face blob as
    GLB and ``.gltf``, the cube as FBX, 3DS and ``.x``, the sphere as DAE,
    STL and OFF, the sky as a run-length ``.hdr`` with an sIBL ``.ibl``);
    the g++ build of the native cooker; ``sl.Mesh.load_threaded`` of every
    format and ``primitive://cube|sphere`` with native cooking (the parse
    and the cooking timed apart first), each mesh's hulls and volume, each
    format's triangles equal to its procedural OBJ's (STL within its 6-
    decimal weld); ``sl.LightMap(sky.ibl)`` on the card, its data
    ``torch.equal`` to ``from_equirect`` of the decoded panorama with the
    same sun; bench-full's composition from the loaded meshes (3 GLB blobs,
    3 primitive spheres, FBX and primitive cubes, the ``.ibl`` light map,
    the plane) settled by ``simulate_tabletop_scene()`` and rendered once at
    640x480: phase 13's content checks, K1's launches by tile (one camera,
    two shadow passes) and no plain piece called, K1 ``torch.equal`` to its
    plain version on the camera and both shadow inputs; ``sl.ImageSaver``
    writes the RGB (RGBA PNG), the depth (16-bit PNG, millimetres) and the
    instance and class maps, which the port's decoder reads back bitwise,
    and ``sl.ImageLoader(dir, seed=0)`` yields 4 textures from them.
16. public table (runs right after phase 13, on its settled scene of seed
    0, which it leaves as it found it): ``sl.Viewer(scene).dashboard()``
    (960, 1280, 3) uint8, first and warm ms; K1's launches per dashboard
    by tile (one camera, two shadow passes: the dark slot 0, the sun in
    slot 1) and no plain piece called; K1 ``torch.equal`` to its plain
    version on the dashboard's camera and both shadow inputs;
    ``play_script`` (a drag, which moves the camera rigidly, a scroll, the
    keys o, m, i, a space and 5 frames of ``Scene.simulate`` with 10
    objects: ``sim_iteration`` 5, ms per frame; each frame differs from the
    one before, but the space's, which only starts the physics);
    ``run(path)`` takes the headless branch and its PNG reads back bitwise
    equal to its dashboard. The web viewer on 127.0.0.1 (``serve(port=0,
    block=False)``): the page, ``/frame.png`` equal to the dashboard it
    rendered, a drag that moves the camera, a key, a 404, ``close()``.
    ``sanitize.debug_nans()`` around a dashboard (raises nothing; its ms
    under the mode) and with object 0's pose NaN (raises naming the aten
    op); ``checked`` on an integer division by zero and out-of-range
    indices on the card, the context alive after. ``profiling.Timer`` with
    ``sync=`` against CUDA events around the same render. ``extension.load``
    of a source against ``sl_decompose.h``. ``ManipulationSim``
    (``tests/test_tools.py::test_manipulation_torque_transfer``'s setup:
    the target pushed and spun, the pusher's rotation locked; ms per step)
    with ``PhysicsTelemetry`` recording each step (summary, JSONL round
    trip, replay). ``JobQueue(num_threads=2)`` settling two scenes of phase
    13's composition (seeds 2 and 3): finite, above the floor, centres in
    view; the pair's wall seconds beside phase 13's serial settle.

17. scale-out (``parallel/distributed.py``, ``generate_batch_sharded``):
    ``generate_batch_sharded`` over ``make_device_mesh()`` (one entry on
    this host) of phase 6's seed, B = 8, full width and depth,
    ``render_sub_batch=3``: every field ``torch.equal`` to phase 6's first
    call, K1's launches equal to phase 6's and no plain piece called,
    seconds and scenes/s beside phase 6's. Two processes spawned on the one
    card (``tests/torch_port_dist.py``), each ``initialize``d into one
    ``gloo`` group of 2 with the mesh row ``[cuda:0]``: B = 4 of bench-full
    with 25 settle frames (cut from 100 to keep the phase near 150 s), each
    process's ``local_batch_slice`` (0:2, 2:4) and frames ``torch.equal`` to
    the parent's ``generate_from_draws`` of its rows at B = 2, whether they
    also equal those rows of the parent's 4-scene batch (a scene's settle
    depends on its batch's size, ROADMAP C-17; reported with the largest
    difference), no ``torch.distributed`` collective (each raises in the
    children), the wall seconds. The atlas modes on phase 4's settled scene
    0: ``shadow_proxy_target=0`` (the full geometry casts: K1 ``torch.equal``
    to its plain version on that shadow input, its launches, the shadow map
    and the frame differ from the default's, ms per render);
    ``cull_closedness=1.0`` with the back-face cull (the bench meshes keep
    their flags: the frame equals the 0.98 threshold's). The scan rule:
    the same scene through the classic raster with ``classic_fine``
    "kernel" and "scan": where the triangle ids differ, (a) ties and edges
    and (b) the rest, which must stay under 0.01% of the pixels and is
    listed; depth within 1e-5 where the ids agree; ms per render and peak
    memory of each.

18. image formats (``assets/jpeg.py``, ``bmp.py``, ``tga.py``, ``gif.py``,
    ``tiff.py`` over the native codec ``csrc/sl_image.cpp``): the codec's
    g++ build on the card's host (seconds); the JPEG (q75, 4:2:0) encodes
    of ``image_fixtures.seeded_images()`` (bench-full's 256^2 blob texture
    and a seeded 640x480 image) and their decodes, and the decodes of the
    committed fixtures (progressive JPEG, interlaced GIF, LZW and Deflate
    TIFF, RLE8 BMP, RLE TGA), each held to the SHA-256 that Pillow 12.1.0
    gave on the CPU host; bench-full's composition at 640x480 from
    ``write_image_fixtures`` (the blob textured from a JPEG through its
    ``.mtl``, a GLB with an embedded JPEG, the plane from a TGA,
    ``sl.LightMap`` of an ``.ibl`` whose ``REFfile`` is a JPEG), settled by
    ``simulate_tabletop_scene()`` (B = 1) and rendered: phase 13's content
    checks, K1's launches (one camera, two shadow passes) and no plain
    piece, K1 ``torch.equal`` to its plain version on each pass, and the
    frame's fields ``torch.equal`` to those of the same scene whose images
    are their decoded pixels (PNG twins, the plane's array); BMP, TGA and
    TIFF round trips of L, RGB and RGBA of the texture and of this render,
    and its depth in mm as 16-bit TIFF, bitwise; the codec's median ms per
    encode and decode of the 640x480 frame (JPEG, PNG, BMP, TGA, TIFF), and
    per decode of its run-length files (RLE TGA, PackBits TIFF, RLE8 and
    RLE4 BMP of its class index; written by ``tests/torch_image_fixtures.py``
    and read back bitwise); ``ImageLoader(num_threads=4)``'s images/s over
    16 JPEG frames, 600 textures timed from its construction;
    ``examples.ycb.run_stream``: 2 batches of 8 at 320x240 with 25 settle
    frames (cut from 100 for time), RGB as PNG and JPEG and the instance
    mask as 16-bit PNG through ``ImageSaver``, every file read back by the
    port's codec.
19. WebP and the tools (``assets/webp.py`` over the native decoder
    ``csrc/sl_webp.cpp``; ``stillleben_tpu_torch/tools/``): the decoder's
    g++ build (seconds); the committed WebP fixtures (lossy, lossy with
    ALPH, lossless, 16 colours, odd-sized, a two-frame animation whose frame
    0 is smaller than its canvas, the 640x480 frame lossy and lossless, the
    scene's images) read both ways, held to the SHA-256 that Pillow 12.1.0
    and OpenCV 5.0.0 gave on the CPU host; phase 18's composition from
    ``write_webp_fixtures`` (the blob's ``.mtl`` texture and a GLB's image
    lossy WebP, the plane a lossless WebP, the ``.ibl``'s panorama a WebP)
    at phase 18's settled poses (no second settle), rendered at 640x480:
    phase 13's content checks, K1's launches (one camera, two shadow passes)
    and no plain piece, K1 ``torch.equal`` to its plain version on the
    camera and the sun's shadow pass, every field ``torch.equal`` to the
    same scene from the decoded arrays (PNG twins of the textures, a BMP
    twin of the panorama: ROADMAP C-18); the median ms of 9 decodes of the
    640x480 frame, lossy and lossless, both readings;
    ``ImageLoader(num_threads=4)``'s images/s over 16 WebP frames, 600
    textures from its construction; ``tools.settle_fidelity`` with ``ref``
    and ``tuned`` at its 24 seeds x 100 frames (its lines, its seconds, and
    the null of ref's two halves of the seeds); ``tools.display_mesh`` (4
    views at 256 of the textured blob), ``tools.viewer_demo`` (12 frames at
    256; its scene's settle cut to 10 frames for time), ``tools.align_mesh``
    (a batch alignment written and read back, an ``AlignSession``'s keys
    and render): K1's launches per tool, no plain piece, K1 ``torch.equal``
    to its plain version on each tool's camera pass.
20. WebP encoding (``assets/webp.py::encode_webp`` over the native encoder
    ``csrc/sl_webp_enc.cpp``): the encoder's g++ build (seconds); the
    committed q80 fixtures re-encoded from their sources (the numpy calls of
    ``tests/torch_image_fixtures.py::make_webp_fixtures``): q80, frame,
    blob_basecolor and sky byte-equal to the files Pillow 12.1.0 wrote, and
    anim around the port's two frames; the RGBA ones (alpha.webp and
    ``image_fixtures.ALPHA_WEBP_FILES``: a palette of 2 colours, 12 levels,
    a raw plane, the horizontal filter) byte-equal to Pillow's files and to
    their SHA-256 (``digests.ALPHA_WEBP_FILE``), their alpha exact; phase
    19's render written by ``sl.ImageSaver`` as RGB and
    as RGBA (alpha 255 on the objects, 0 elsewhere), read back by the
    port's decoder (alpha exact, RGB PSNR against the render, bytes); the
    median ms of 9 encodes of 640x480 (the frame and the render, RGB and
    RGBA, and the frame with a smooth alpha: libwebp's VP8L predictor
    path); ``ImageSaver(num_threads=4)``'s images/s over 16 frames, each
    file equal to the serial encode. No kernel: K1's entries of phase 19
    cover the render.
21. GIF and Netpbm encoding (``assets/gif.py::encode_gif`` over the
    native encoder ``csrc/sl_gif_enc.cpp``: Pillow's median cut, fast octree
    and GIF's LZW; ``assets/netpbm.py``): the encoder's g++ build
    (seconds); the committed encode fixtures (GIF of an RGB ramp, of RGB
    noise, of RGBA and of 16-bit depth; a 16-bit PGM; a P6) re-encoded from
    ``image_fixtures.encode_sources()``, each byte-equal to the file Pillow
    12.1.0 wrote (and to its SHA-256); phase 19's render written by
    ``sl.ImageSaver`` as ``.gif`` in RGB and in RGBA (alpha 255 on the
    objects, 0 elsewhere), read back by the port's decoder and equal to
    the port's palette at its index image (the colour count, the PSNR
    against the render, whether the transparent pixels are exactly the
    background); the render's depth in mm as a 16-bit ``.pgm``, read back
    bitwise in OpenCV's reading and clipped at 255 in Pillow's; the median
    ms of 9 encodes (GIF RGB, GIF RGBA, PGM 16-bit);
    ``ImageSaver(num_threads=4)``'s images/s over 16 GIF frames, each file
    equal to the serial encode. No kernel: K1's entries of phase 19 cover
    the render.
22. QOI, SGI, PCX/DCX, IM and DDS (``assets/qoi.py``, ``sgi.py``,
    ``pcx.py``, ``im.py``, ``dds.py`` over the native core
    ``csrc/sl_plain_formats.cpp``): the core's g++ build (seconds); the
    committed encode fixtures re-encoded from
    ``image_fixtures.plain_sources()``, each byte-equal to the file Pillow
    12.1.0 wrote (and to its SHA-256), and every read fixture (run-length
    SGI, 1-bit and 4-plane PCX, a DCX, IM with a palette and of floats,
    Pillow's DXT1/3/5 and BC5, random BC4/BC5S/BC6H/BC6HS/BC7 blocks, masked
    and palette DDS) decoded to the SHA-256 of Pillow's reading; phase 19's
    render through ``sl.ImageSaver`` in RGB and RGBA (alpha 255 on the
    objects, 0 elsewhere) as ``.qoi .sgi .pcx .im .dds``, each read back
    bitwise, RGBA as PCX printed as refused and not written, and its depth
    in mm as a 16-bit ``.im`` read back clipped at 255 as Pillow reads it;
    the median ms of 9 encodes and decodes of the 640x480 render per format
    and of a BC7 decode of a 640x480 DDS of random blocks. No kernel: K1's
    entries of phase 19 cover the render.
23. JPEG variants (``assets/jpeg.py`` over ``csrc/sl_image.cpp``:
    arithmetic coding, lossless SOF3, CMYK and YCCK, libjpeg's block
    smoothing, and the files both libraries refuse): every committed
    variant fixture (``image_fixtures.JPEG_VARIANT_FILES``, written by
    libjpeg-turbo 3.1 and Pillow on the CPU host) read both ways to the
    SHA-256 of Pillow 12.1.0's and OpenCV 5.0.0's readings (or refused as
    they refuse it); the median ms of 9 decodes, both readings, taken in
    turns, of the 640x480 frame in six variants and as a baseline Huffman
    file of the same pixels; phase 18's
    scene at its settled poses (no second settle) with the blob's texture
    from an arithmetic progressive JPEG, a GLB with an embedded Adobe CMYK
    JPEG, the plane from a lossless JPEG and the light map's panorama a YCCK
    JPEG (OpenCV's reading): phase 13's content checks, K1's launches (one
    camera, two shadow passes) and no plain piece, K1 ``torch.equal`` to its
    plain version on the camera and the sun's shadow pass, every field
    ``torch.equal`` to the same scene from the files' PNG twins. Then the
    smoke's total wall seconds.

The last three lines are a JSON object of the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 640, 480
BATCH = 8
TUNED_BATCH = 16  # TUNED.json's BENCH_BATCH
SLICE_BATCH, SLICE_ITERATIONS = 2, 25  # phase 7, cut to stay in time
SHADOW_SIZE = 2048
SEED = 0
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES = 3.35e12  # HBM3
# float32 instructions that are not fused multiply-adds: the data sheet's
# 67 TFLOP/s counts an FMA as two operations; one instruction per lane and
# clock is 132 SMs x 128 lanes x 1.98 GHz. The raster kernels are built
# with --fmad=false and explicit _rn intrinsics, so each counted operation
# is one instruction.
PEAK_F32_OPS = 132 * 128 * 1.98e9  # 33.5e12 per second
# The operations that z-buffering K1's and K2's inputs needs, counted
# from this run's data. Per (live slot, 8x4-pixel patch of its tile) a
# cull, whether the triangle can touch the patch: per edge its value at the
# patch's middle (2 mul + 2 add), its half-range over the patch (2 abs + 2
# mul + 1 add) and two range tests (2 add + 2 compares), and 2 to combine
# the edges. Per pixel of a patch that the cull keeps, the inside test: E0,
# E1, E2 (2 mul + 2 add each) and 6 sign compares. Per pixel inside, the
# depth path: Esum and Ez (2 mul + 2 add each), the division, |Esum| and its
# compare, the near/far/floor compares and the 2 compares of the running
# minimum.
CULL_OPS = 3 * 13 + 2
INSIDE_OPS = 3 * 4 + 6
DEPTH_OPS = 2 * 4 + 1 + 2 + 3 + 2
ROW_BYTES = 16 * 4  # one packed line row LT[id]
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's 1.98 GHz boost clock
WEBP_SAVER_FRAMES = 16  # phase 20's ImageSaver(num_threads=4) run
GIF_SAVER_FRAMES = 16  # phase 21's ImageSaver(num_threads=4) run
PLAIN_EXTS = (".qoi", ".sgi", ".pcx", ".im", ".dds")  # phase 22's formats
T_START = 0.0  # main()'s start, for the total wall time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


# the sky's analytic sun (bench.py:122-124); the template does not read it
SUN_LIGHT = ((0.3 / 0.98994949, 0.5 / 0.98994949, -0.8 / 0.98994949), (3.0, 2.8, 2.5))


def load_meshes(subdiv: int, textured: bool = False, cutout: bool = False,
                native_decomp: bool = True):
    """(dense, cube, sphere) from the procedural OBJ files, classes 1..3;
    ``textured``: the dense mesh with its uv map and base-colour PNG;
    ``cutout``: a fourth mesh, the cube with the cutout texture (class 4);
    ``native_decomp=False``: hulls cooked by the Python decomposition."""
    from stillleben_tpu_torch.assets.mesh import Mesh
    from stillleben_tpu_torch.assets.procedural import write_meshes

    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    os.environ["STILLLEBEN_TPU_MESH_CACHE"] = os.path.join(build, "mesh_cache")
    paths = write_meshes(os.path.join(build, "meshes"), subdiv=subdiv, seed=0)
    os.environ["STILLLEBEN_TPU_NATIVE_DECOMP"] = "1" if native_decomp else "0"
    try:
        dense = Mesh(paths["blob_textured" if textured else "blob"],
                     flags=Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL)
        meshes = [dense, Mesh(paths["cube"]), Mesh(paths["sphere"])]
        if cutout:
            meshes.append(Mesh(paths["cube_cutout"]))
    finally:
        del os.environ["STILLLEBEN_TPU_NATIVE_DECOMP"]
    dense.center_bbox()
    for i, mesh in enumerate(meshes):
        mesh.class_index = i + 1
    return meshes


def build_scene(order, width: int, height: int, light_map=None, plane: float = 0.0):
    """Objects with the seeded metallic/roughness overrides of
    bench.py:116-118; with ``light_map`` and ``plane`` > 0 the sky and a
    ``plane`` x ``plane`` m background plane with the 512^2 checker."""
    from stillleben_tpu_torch.assets.procedural import checker_texture
    from stillleben_tpu_torch.assets.texture import Texture2D
    from stillleben_tpu_torch.scene.scene import Object, Scene

    import numpy as np

    rng = np.random.default_rng(7)
    scene = Scene((width, height))
    for mesh in order:
        o = Object(mesh)
        o.metallic, o.roughness = float(rng.random()), float(rng.random())
        scene.add_object(o)
    scene.light_map = light_map
    if plane:
        scene.background_plane_size = np.array([plane, plane], np.float32)
        scene.background_plane_texture = Texture2D(checker_texture())
    return scene


def bench_scene():
    """The bench workload (bench.py:97-119) with a procedural dense mesh
    (81,920 faces) in place of the scanned bunny: [dense, cube, sphere] x 3
    + [cube]."""
    dense, cube, sphere = load_meshes(subdiv=6)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.2)
    sphere.scale_to_bbox_diagonal(0.15)
    return build_scene([dense, cube, sphere] * 3 + [cube], WIDTH, HEIGHT)


def bench_full_scene(light_map):
    """The bench workload "textured" (bench.py:87-136): the same 10
    objects, the dense mesh with its base-colour texture, the sky light
    map and a 3 x 3 m background plane with the checker."""
    dense, cube, sphere = load_meshes(subdiv=6, textured=True)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.2)
    sphere.scale_to_bbox_diagonal(0.15)
    return build_scene([dense, cube, sphere] * 3 + [cube], WIDTH, HEIGHT, light_map, plane=3.0)


def extras_scene(light_map):
    """One scene for what bench-full leaves off: the cube with the cutout
    texture, the textured dense mesh and a sphere, both with a seeded
    sticker of its own size, and a cube; sky and plane as in bench-full."""
    import numpy as np

    from stillleben_tpu_torch.assets.texture import Texture

    dense, cube, sphere, cutout = load_meshes(subdiv=6, textured=True, cutout=True)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.2)
    sphere.scale_to_bbox_diagonal(0.15)
    cutout.scale_to_bbox_diagonal(0.25)
    scene = build_scene([cutout, dense, sphere, cube], WIDTH, HEIGHT, light_map, plane=3.0)
    rng = np.random.default_rng(SEED)
    for o, (h, w) in zip(scene.objects[1:3], ((48, 64), (32, 24))):
        pixels = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
        pixels[..., 3] = np.maximum(pixels[..., 3], 128)
        o.sticker_texture = Texture(pixels)
        o.sticker_range = np.array([-0.5, -0.5, 1.0, 1.0], np.float32)
        o.sticker_rotation = np.array([0.9238795, 0.3826834, 0.0, 0.0], np.float32)
    return scene


def small_full_scene(light_map):
    """The small scene with the textured dense mesh, sky and plane, 160x120:
    the scene of ``tests/test_torch_gpu.py::small_full_templates``, whose
    hulls the Python decomposition cooks. Its card-against-CPU bound (1% of
    the object pixels beyond 2e-4) holds where no object lies in a wide VSM
    penumbra: with native hulls this scene settles otherwise, and a 3e-7
    change of the poses moves 5.8-6.2% of its object pixels beyond 2e-4 on
    the CPU alone (ROADMAP.md, C-14)."""
    dense, cube, sphere = load_meshes(subdiv=3, textured=True, native_decomp=False)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.25)
    sphere.scale_to_bbox_diagonal(0.3)
    return build_scene([dense, cube, sphere], 160, 120, light_map, plane=3.0)


def small_scene():
    """The CPU tests' scene (a 1,280-face dense mesh, a cube, a sphere) at
    160x120, where the raster's per-tile capacity holds every triangle."""
    dense, cube, sphere = load_meshes(subdiv=3)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.25)
    sphere.scale_to_bbox_diagonal(0.3)
    return build_scene([cube, sphere, dense], 160, 120)


def cuda_time(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` warm runs (CUDA events).
    A spin kernel of ~20 ms runs first, so the host has queued every run
    before the start event: the time is the device's, not the host's
    launch overhead (about 0.03 ms per wrapper call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of bytes over
    the memory rate and float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_ops(torch, rows, ox, oy, tile: int) -> tuple[int, int, int, int]:
    """The operations that z-buffering the line rows ``rows`` (S, 16) of
    live slots needs, each slot over its tile at pixel origin (ox, oy)
    (S,): CULL_OPS per (slot, patch), INSIDE_OPS per pixel of each (slot,
    patch) pair whose patch the triangle can touch, DEPTH_OPS per (slot,
    pixel) inside. The cull is exact (float64, no margin). Returns
    (operations, slot-patch pairs, kept pairs, inside pairs)."""
    dev = rows.device
    f64 = torch.float64
    pxo = torch.arange(0, tile, 8, device=dev, dtype=f64).repeat(tile // 4)
    pyo = torch.arange(0, tile, 4, device=dev, dtype=f64).repeat_interleave(tile // 8)
    lane = torch.arange(32, device=dev)
    dx, dy = (lane % 8).to(f64) + 0.5, (lane // 8).to(f64) + 0.5
    pairs = rows.shape[0] * pxo.numel()
    kept = inside = 0
    for s0 in range(0, rows.shape[0], 4096):
        g = rows[s0:s0 + 4096].to(f64)
        xo, yo = ox[s0:s0 + 4096].to(f64)[:, None], oy[s0:s0 + 4096].to(f64)[:, None]
        xc, yc = xo + pxo + 4.0, yo + pyo + 2.0  # (s, P) patch middles
        below = torch.zeros(xc.shape, dtype=torch.bool, device=dev)
        above = torch.zeros_like(below)
        for e in range(3):
            lx, ly, lc = g[:, 3 * e, None], g[:, 3 * e + 1, None], g[:, 3 * e + 2, None]
            c = lx * xc + ly * yc + lc
            r = lx.abs() * 3.5 + ly.abs() * 1.5
            below |= c + r < 0
            above |= c - r > 0
        s_i, p_i = torch.nonzero(~(below & above), as_tuple=True)
        kept += int(s_i.numel())
        X = (xo[s_i] + pxo[p_i, None]) + dx  # (k, 32) pixel centres
        Y = (yo[s_i] + pyo[p_i, None]) + dy
        gk = g[s_i]
        E = [gk[:, 3 * e, None] * X + gk[:, 3 * e + 1, None] * Y + gk[:, 3 * e + 2, None]
             for e in range(3)]
        ins = ((E[0] >= 0) & (E[1] >= 0) & (E[2] >= 0)) | ((E[0] <= 0) & (E[1] <= 0) & (E[2] <= 0))
        inside += int(ins.sum())
    n_ops = pairs * CULL_OPS + kept * 32 * INSIDE_OPS + inside * DEPTH_OPS
    return n_ops, pairs, kept, inside


def compare(torch, kernel_out, plain_out) -> tuple[bool, float]:
    """(bitwise equal, max |w| difference over pixels finite in both; inf
    where only one is finite)."""
    (wk, tk), (wp, tp) = kernel_out, plain_out
    bitwise = torch.equal(wk, wp) and torch.equal(tk, tp)
    both = torch.isfinite(wk) & torch.isfinite(wp)
    err = float((wk[both] - wp[both]).abs().max()) if both.any() else 0.0
    if not torch.equal(torch.isfinite(wk), torch.isfinite(wp)):
        err = float("inf")
    return bitwise, err


def capture(module, attr: str, key, run) -> dict:
    """Run ``run()`` with ``module.attr`` wrapped so that each call's
    arguments are kept (cloned), keyed by ``key(args, kwargs)``."""
    captured = {}
    original = getattr(module, attr)

    def recorder(*args, **kwargs):
        captured[key(args, kwargs)] = (
            tuple(a.clone() if hasattr(a, "clone") else a for a in args), dict(kwargs)
        )
        return original(*args, **kwargs)

    setattr(module, attr, recorder)
    try:
        run()
    finally:
        setattr(module, attr, original)
    return captured


def count_calls(module, attrs, run):
    """Run ``run()`` with each ``module.attr`` wrapped to count its calls;
    returns (its result, {attr: calls})."""
    counts = dict.fromkeys(attrs, 0)
    originals = {a: getattr(module, a) for a in attrs}

    def counter(attr):
        def wrapped(*args, **kwargs):
            counts[attr] += 1
            return originals[attr](*args, **kwargs)
        return wrapped

    for a in attrs:
        setattr(module, a, counter(a))
    try:
        return run(), counts
    finally:
        for a, f in originals.items():
            setattr(module, a, f)


def capture_all(module, attr: str, run) -> list:
    """Run ``run()`` with ``module.attr`` wrapped so that every call's
    arguments are kept (cloned), in call order."""
    calls = []
    original = getattr(module, attr)

    def recorder(*args, **kwargs):
        calls.append((tuple(a.clone() if hasattr(a, "clone") else a for a in args), dict(kwargs)))
        return original(*args, **kwargs)

    setattr(module, attr, recorder)
    try:
        run()
    finally:
        setattr(module, attr, original)
    return calls


def record_settles(torch, tt, run):
    """Run ``run()`` with ``tabletop.settle_with_stop`` timed (the device
    synchronized around it) and its stop frames kept; returns (run's
    result, [(seconds, stop frames per scene)])."""
    settles = []
    original = tt.settle_with_stop

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        settles.append((time.perf_counter() - t0, out[1].tolist()))
        return out

    tt.settle_with_stop = timed
    try:
        return run(), settles
    finally:
        tt.settle_with_stop = original


def check_frames(torch, frames, what: str) -> str:
    for f in ("hdr", "object_coordinates", "cam_coordinates", "normals",
              "barycentric_coeffs", "depth"):
        if not torch.isfinite(getattr(frames, f)).all():
            fail(f"{what}: non-finite values in {f}")
    inst_px = frames.valid.flatten(1).sum(1)
    rgb_std = float(frames.rgb.float().std())
    if not (inst_px > 0).all():
        fail(f"{what}: a scene without object pixels: {inst_px.tolist()}")
    if rgb_std <= 1.0:
        fail(f"{what}: rgb std {rgb_std} <= 1: blank frames")
    classes = sorted(int(c) for c in torch.unique(frames.class_index.to(torch.int32)).tolist())
    return f"object pixels per scene {inst_px.tolist()}, classes {classes}, rgb std {rgb_std:.2f}"


def check_k1(torch, cr, args, label: str, card: str) -> dict:
    """K1 on one captured call: equal to its plain version, timed beside
    its bound, with its fixed cost and its heaviest cell apart."""
    LT, ids, cell_tile, md, near, far, tw, tile, n_tiles = args
    out_k = cr.cell_raster(*args)
    bitwise, err = compare(torch, out_k, cr.cell_raster_plain(*args))
    ms = cuda_time(torch, lambda: cr.cell_raster(*args), 50)
    plain_ms = cuda_time(torch, lambda: cr.cell_raster_plain(*args), 3)
    # what the merge alone costs: the key buffer's fill and unpack, no
    # valid cell; and what the cell with the most live slots costs alone
    valid = cell_tile < n_tiles
    no_cells = torch.full_like(cell_tile, n_tiles)
    keys_ms = cuda_time(
        torch, lambda: cr.cell_raster(LT, ids, no_cells, md, near, far, tw, tile, n_tiles), 50)
    heavy = no_cells.clone()
    top = int(((ids >= 0).sum(1) * valid).argmax())
    heavy[top] = cell_tile[top]
    heavy_ms = cuda_time(
        torch, lambda: cr.cell_raster(LT, ids, heavy, md, near, far, tw, tile, n_tiles), 50)
    live = (ids >= 0) & valid[:, None]
    slots = int(live.sum())
    slot_tile = cell_tile[:, None].expand_as(ids)[live]
    n_ops, pairs, kept, inside = needed_ops(
        torch, LT[ids[live].long()], tile * (slot_tile % tw), tile * (slot_tile // tw), tile)
    n_bytes = (slots * ROW_BYTES + (ids.numel() + cell_tile.numel()) * 4
               + (0 if md is None else n_tiles * tile * tile * 4) + 2 * out_k[0].numel() * 4)
    b_ms, b_by = bound(n_bytes, n_ops)
    phase("kernel", f"K1 {label}: tile {tile}, md_tiles {'given' if md is not None else 'None'}, "
                    f"{ids.shape[0]} cells x C {ids.shape[1]}, "
                    f"{int(valid.sum())} valid, {slots} live slots in valid cells, "
                    f"{n_tiles} tiles; equal: {bitwise}; max_abs_err {err}; kernel {ms:.4f} ms "
                    f"(with no valid cell {keys_ms:.4f} ms, the heaviest cell "
                    f"({int((ids[top] >= 0).sum())} live slots) alone {heavy_ms:.4f} ms), "
                    f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes} B, "
                    f"{n_ops} ops: {pairs} slot-patch pairs, {kept} kept, {inside} slot-pixel "
                    f"pairs inside) ({card})")
    if not bitwise:
        fail(f"K1 {label} tile {tile}: kernel and plain version differ")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def check_k2(torch, fr, args, kw, label: str, card: str) -> tuple[dict, tuple, tuple]:
    """K2 on one captured call, as ``check_k1``; also returns its output
    and the plain version's."""
    LT, ids, md = args[:3]
    tw, tile_offset, tile = args[6], kw.get("tile_offset", 0), kw["tile"]
    out_k = fr.fine_raster(*args, **kw)
    out_p = fr.fine_raster_plain(*args, **kw)
    bitwise, err = compare(torch, out_k, out_p)
    ms = cuda_time(torch, lambda: fr.fine_raster(*args, **kw), 50)
    plain_ms = cuda_time(torch, lambda: fr.fine_raster_plain(*args, **kw), 3)
    # what empty tiles alone cost (every slot masked), against a fill of
    # the outputs; and what the heaviest tile costs alone
    no_slots = torch.full_like(ids, -1)
    empty_ms = cuda_time(torch, lambda: fr.fine_raster(LT, no_slots, *args[2:], **kw), 50)
    fill_ms = cuda_time(torch, lambda: (torch.full_like(out_k[0], float("inf")),
                                        torch.full_like(out_k[1], -1)), 50)
    heavy = heaviest_alone(torch, ids)
    heavy_ms = cuda_time(torch, lambda: fr.fine_raster(LT, heavy, *args[2:], **kw), 50)
    live = ids >= 0
    slots = int(live.sum())
    gi = tile_offset + torch.arange(ids.shape[0], device=ids.device)[:, None, None].expand_as(ids)[live]
    n_ops, pairs, kept, inside = needed_ops(
        torch, LT[ids[live].long()], tile * (gi % tw), tile * (gi // tw), tile)
    n_bytes = slots * ROW_BYTES + (ids.numel() + md.numel()) * 4 + 2 * out_k[0].numel() * 4
    b_ms, b_by = bound(n_bytes, n_ops)
    occupied = int(live.any(-1).sum())
    per_tile = live.flatten(1).sum(1)
    phase("kernel", f"K2 {label}: tile {tile}, {ids.shape[0]} tiles x {ids.shape[1]} "
                    f"chunks x C {ids.shape[2]}, {occupied} occupied chunks, {slots} live "
                    f"slots, {int((per_tile > 0).sum())} occupied tiles, at most "
                    f"{int(per_tile.max())} slots in a tile; equal: {bitwise}; max_abs_err "
                    f"{err}; kernel {ms:.4f} ms (every slot masked {empty_ms:.4f} ms, a fill of "
                    f"the outputs {fill_ms:.4f} ms, the heaviest tile alone {heavy_ms:.4f} ms), "
                    f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes} B, "
                    f"{n_ops} ops: {pairs} slot-patch pairs, {kept} kept, {inside} slot-pixel "
                    f"pairs inside) ({card})")
    if not bitwise:
        fail(f"K2 {label} tile {tile}: kernel and plain version differ")
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by),
            out_k, out_p)


def heaviest_alone(torch, ids):
    """``ids`` with every tile but the one with the most live slots masked."""
    heavy = torch.full_like(ids, -1)
    top = int((ids >= 0).flatten(1).sum(1).argmax())
    heavy[top] = ids[top]
    return heavy


def k3_groups(torch, ids, tpg: int) -> tuple[int, int]:
    """K3's groups of ``tpg`` consecutive tiles on these ids: (groups,
    groups with an occupied tile)."""
    occupied = (ids >= 0).flatten(1).any(1)
    n_groups = -(-ids.shape[0] // tpg)
    occupied = torch.nn.functional.pad(occupied, (0, n_groups * tpg - occupied.numel()))
    return n_groups, int(occupied.reshape(n_groups, tpg).any(1).sum())


def check_k3(torch, fr, args, kw, label: str, card: str, k2: dict, out_k, out_p,
             tpg: int) -> dict:
    """K3 (``tpg`` tiles per block) on K2's captured call: equal to the
    plain version and to K2; timed beside K2 in turns (K2, K3, K3, K2) on
    the call's ids, with every slot masked and with only the heaviest tile.
    Its bound is K2's: the work is the same."""
    LT, ids = args[:2]
    tile = kw["tile"]
    kw3 = dict(kw, tiles_per_cell=tpg)
    out3 = fr.fine_raster(*args, **kw3)
    eq_plain, err = compare(torch, out3, out_p)
    eq_k2, _ = compare(torch, out3, out_k)
    times = {}
    for what, inp in (("call", ids), ("masked", torch.full_like(ids, -1)),
                      ("heaviest", heaviest_alone(torch, ids))):
        def run_k2(inp=inp):
            return fr.fine_raster(LT, inp, *args[2:], **kw)

        def run_k3(inp=inp):
            return fr.fine_raster(LT, inp, *args[2:], **kw3)

        a, b, c, d = (cuda_time(torch, f, 50) for f in (run_k2, run_k3, run_k3, run_k2))
        times[what] = ((b + c) / 2, (a + d) / 2)
    ms, k2_ms = times["call"]
    per_tile = (ids >= 0).flatten(1).sum(1)
    n_groups, occupied = k3_groups(torch, ids, tpg)
    b_ms = k2["bound_ms"]
    phase("kernel", f"K3 {label}: tile {tile}, {tpg} tiles per block, {ids.shape[0]} tiles, "
                    f"{int((per_tile > 0).sum())} occupied tiles in {occupied} of {n_groups} "
                    f"groups ({n_groups} occupancy blocks, K2 {ids.shape[0]}); equal to the "
                    f"plain version: {eq_plain}, to K2: {eq_k2}; "
                    f"max_abs_err {err}; kernel {ms:.4f} ms, K2 {k2_ms:.4f} ms in turns (every "
                    f"slot masked {times['masked'][0]:.4f} ms, K2 {times['masked'][1]:.4f} ms; the "
                    f"heaviest tile ({int(per_tile.max())} live slots) alone "
                    f"{times['heaviest'][0]:.4f} ms, K2 {times['heaviest'][1]:.4f} ms); bound "
                    f"{b_ms:.4f} ms ({k2['bound_by']}), K3 / bound {ms / b_ms:.1f}, K3 / K2 "
                    f"{ms / k2_ms:.2f} ({card})")
    if not (eq_plain and eq_k2):
        fail(f"K3 {label} tile {tile} tpg {tpg}: differs from the plain version or from K2")
    return dict(max_abs_err=err, ms=ms, plain_ms=k2["plain_ms"], bound_ms=b_ms,
                bound_by=k2["bound_by"], k2_ms=k2_ms)


def stage_times(torch, run) -> list[tuple[str, float]]:
    """Run ``run()`` once with the render's stage marks recording CUDA
    events; returns (stage, ms) in order, each stage ending at its mark."""
    from stillleben_tpu_torch.render import stages

    events = []

    def hook(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    torch.cuda.synchronize()
    stages.set_hook(hook)
    try:
        hook("start")
        run()
    finally:
        stages.set_hook(None)
    torch.cuda.synchronize()
    return [(name, events[i][1].elapsed_time(e)) for i, (name, e) in enumerate(events[1:])]


def check_full_frames(torch, frames, what: str) -> str:
    """What the full configuration adds to ``check_frames``: the plane's
    pixels are valid with class, instance and vertex ids 0; every scene
    shows objects too; behind everything is the skybox (alpha 1), never the
    background colour (alpha 0)."""
    inst = frames.instance_index.to(torch.int32)
    plane = frames.valid & (inst == 0)
    plane_px = plane.flatten(1).sum(1)
    obj_px = (frames.valid & (inst > 0)).flatten(1).sum(1)
    sky = ~frames.valid
    if not (plane_px > 0).all() or not (obj_px > 0).all():
        fail(f"{what}: plane pixels {plane_px.tolist()}, object pixels {obj_px.tolist()}")
    if (frames.class_index.to(torch.int32)[plane] != 0).any() or (
            frames.vertex_indices[plane] != 0).any():
        fail(f"{what}: plane pixels with a class or a vertex id")
    if not (frames.hdr[sky][:, 3] == 1).all():
        fail(f"{what}: background colour where the skybox must show")
    return (f"plane pixels per scene {plane_px.tolist()} (class 0, instance 0), object pixels "
            f"{obj_px.tolist()}, skybox pixels {sky.flatten(1).sum(1).tolist()} (alpha 1)")


def sticker_footprint(torch, scene, frame):
    """(H, W) bool: pixels of an object with a sticker whose object
    coordinates project into the sticker's range (widened by 1e-4 of it,
    for pixels on its border)."""
    dev = frame.hdr.device
    inst = frame.instance_index.to(torch.int32)
    obj = torch.cat([frame.object_coordinates[..., :3],
                     torch.ones_like(frame.object_coordinates[..., :1])], -1)
    out = torch.zeros(inst.shape, dtype=torch.bool, device=dev)
    for o in scene.objects:
        if o.sticker_texture is None:
            continue
        vp = torch.from_numpy(o.sticker_view_projection()).to(dev)
        rng = torch.from_numpy(o.sticker_range).to(dev)
        st = obj @ vp.T
        uv = (st[..., :2] / st[..., 3:4] - rng[:2]) / rng[2:]
        inside = ((uv > -1e-4) & (uv < 1 + 1e-4)).all(-1)
        out |= frame.valid & (inst == o.instance_index) & inside
    return out


def run_rungs(torch, cr, fr, rt, ftpl, fcfg, light_map, render, card) -> dict:
    """Phase 10: the tuned and the reference-quality rungs of bench.py on
    the bench-full template, their kernels against the plain versions, and
    one render each of the other modes. Returns the kernels' JSON entries."""
    import copy

    import numpy as np

    from stillleben_tpu_torch.parallel.batch import _to_host, generate_batch, generate_stream
    from stillleben_tpu_torch.physics import tabletop as tt
    from stillleben_tpu_torch.physics.types import default_config

    plain_k1 = ("cell_raster_plain", "merge_cells", "cell_raster_reference")
    plain_k2 = ("fine_raster_plain", "fine_raster_reference")
    # TUNED.json: the back-face cull, the 1-tap VSM, the nearest prefiltered
    # level; the frame cadence, 128 narrowphase pairs, the sleep exit; B = 16
    tuned_cfg = fcfg._replace(backface_cull=True, vsm_taps=1, ibl_prefilter="nearest")
    tuned_solver = default_config()._replace(contact_gen="frame", max_narrow_pairs=128,
                                             sleep_frames=10)
    # bench.py:226-242, :282-286: PCF, the reference SSAO, 3 shadowed light
    # slots; the substep cadence with 256 pairs; B = 8
    ref_cfg = fcfg._replace(shadow_mode="pcf", ssao_mode="reference", max_lights=3)
    ref_solver = default_config()._replace(contact_gen="substep", max_narrow_pairs=256)
    # BENCH_LIGHTS=3 gives the light map two more lights (bench.py:124-130),
    # on bench-full's precomputed data. Neither package's template reads a
    # light map's lights: the template's three slots hold the scene's light
    # 0, replaced by each scene's random light, and two dark slots, whose
    # shadow passes run all the same. So the rung renders bench-full's
    # template.
    lm3 = copy.copy(light_map)
    for d in ((-0.5, -0.3, -0.9), (-0.3, -0.3, -0.9)):
        lm3.light_directions = np.concatenate(
            [lm3.light_directions, (np.asarray(d, np.float32) / np.linalg.norm(d))[None]])
        lm3.light_colors = np.concatenate([lm3.light_colors, np.float32([[1.5, 1.5, 1.6]])])
    rtpl = ftpl
    phase("rungs", f"refmode light map: {len(lm3.light_directions)} lights, bench-full's "
                   f"precomputed data shared: {lm3.data is light_map.data}; light slots of the "
                   f"template: {rtpl.base_inputs.light_colors.shape[0]}")

    def drive(batch, cfg, solver, seed):
        """One generate_batch from zeroed launch counts; returns (frames,
        seconds, settles, K1 launches by tile, K2 launches, plain calls)."""
        cr.reset_launch_counts()
        fr.reset_launch_counts()
        gen = torch.Generator().manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (frames, plain), settles = record_settles(torch, tt, lambda: count_calls(
            cr, plain_k1, lambda: generate_batch(gen, batch, ftpl if cfg is tuned_cfg else rtpl,
                                                 cfg, solver)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (frames, secs, settles, dict(cr.cell_raster.launches_by_tile),
                fr.fine_raster.launches, plain)

    out = {}
    for name, batch, cfg, solver, seed, shadow_passes in (
        ("tuned", TUNED_BATCH, tuned_cfg, tuned_solver, SEED + 5, 1),
        ("refmode", BATCH, ref_cfg, ref_solver, SEED + 7, 3),
    ):
        frames, secs, settles, k1, k2, plain = drive(batch, cfg, solver, seed)
        (settle_s, stops), = settles
        phase("rungs", f"{name}: generate_batch B={batch} {WIDTH}x{HEIGHT}, first call: "
                       f"{secs:.3f} s, {batch / secs:.4f} scenes/s; settle ({solver.contact_gen} "
                       f"cadence, {solver.max_narrow_pairs} pairs, sleep_frames "
                       f"{solver.sleep_frames}) {settle_s:.3f} s, stop frame per scene {stops}; "
                       f"render {(secs - settle_s) / batch * 1e3:.2f} ms per scene; K1 launches "
                       f"by tile {k1}, K2/K3 launches {k2}; calls of K1's plain pieces {plain} "
                       f"({card})")
        phase("rungs", f"{name}: content: {check_frames(torch, frames, name)}; "
                       f"{check_full_frames(torch, frames, name)}")
        if (k1.get(16, 0) != batch or k1.get(32, 0) != shadow_passes * batch or k2
                or any(plain.values())):
            fail(f"{name}: K1 launches {k1}, K2 launches {k2}, plain calls {plain}")
        out[name] = dict(k1=k1, frames=frames if name == "tuned" else None)
        del frames

    # the tuned rung's steady state: generate_stream, 3 batches, 2 ahead,
    # the training subset narrowed on the card
    fields = ("rgb", "instance_index", "class_index", "depth")
    ready = []
    cr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def stream():
        got = []
        for b in generate_stream(ftpl, tuned_cfg, tuned_solver, batch=TUNED_BATCH, n_batches=3,
                                 seed=SEED + 6, prefetch=2, gt_fields=fields):
            ready.append(time.perf_counter() - t0)
            got.append(b)
        return got

    (batches, plain), settles = record_settles(torch, tt, lambda: count_calls(cr, plain_k1, stream))
    stream_s = time.perf_counter() - t0
    stream_k1 = dict(cr.cell_raster.launches_by_tile)
    for b in batches:
        want = {"rgb": (np.uint8, 4), "instance_index": (np.uint16, 0),
                "class_index": (np.uint16, 0), "depth": (np.float16, 0)}
        for f, (dt, ch) in want.items():
            shape = (TUNED_BATCH, HEIGHT, WIDTH) + ((ch,) if ch else ())
            if b[f].dtype != dt or b[f].shape != shape:
                fail(f"stream: {f} is {b[f].dtype} {b[f].shape}, expected {dt.__name__} {shape}")
        if not np.isfinite(b["depth"]).all() or not (b["instance_index"] > 0).any(axis=(1, 2)).all():
            fail("stream: non-finite depth or a scene without object pixels")
    # what the copy stream overlaps: one batch's narrowing and copy alone
    frames = out["tuned"]["frames"]
    narrowed = {f: getattr(frames, f) for f in fields}
    narrowed = {f: x.to(torch.float16) if x.dtype == torch.float32 else x for f, x in narrowed.items()}
    copy_stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host, _ = _to_host(narrowed, copy_stream)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t1) * 1e3
    n_bytes = sum(x.numel() * x.element_size() for x in narrowed.values())
    phase("rungs", f"tuned: generate_stream 3 x B={TUNED_BATCH} (prefetch 2, fields {fields}): "
                   f"{stream_s:.3f} s, steady {3 * TUNED_BATCH / stream_s:.4f} scenes/s; batches "
                   f"read back at {[round(t, 3) for t in ready]} s; settles "
                   f"{[(round(t, 3), st) for t, st in settles]}; K1 launches by tile {stream_k1}; "
                   f"plain calls {plain}; one batch's narrowing + copy to pinned memory alone "
                   f"({n_bytes} B) {copy_ms:.2f} ms ({card})")
    if len(batches) != 3 or any(plain.values()) or stream_k1.get(16, 0) != 3 * TUNED_BATCH:
        fail(f"stream: {len(batches)} batches, K1 launches {stream_k1}, plain calls {plain}")
    del batches, frames, narrowed, host, out["tuned"]["frames"]

    # the rungs' renders of phase 4's 8 settled poses, and where the time
    # of one refmode render goes
    per_render = {}
    for name, c in (("tuned", tuned_cfg), ("refmode", ref_cfg)):
        render(c, 0, rtpl)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(BATCH):
            render(c, b, rtpl)
        torch.cuda.synchronize()
        per_render[name] = round((time.perf_counter() - t0) / BATCH * 1e3, 2)
    times = stage_times(torch, lambda: render(ref_cfg, 0, rtpl))
    phase("stages", f"render per scene on phase 4's poses, ms: {per_render}; refmode, one "
                    "render, device ms by stage: " + ", ".join(f"{n} {ms:.3f}" for n, ms in times)
                    + f"; total {sum(ms for _, ms in times):.3f} ms ({card})")

    # the kernels on the rungs' inputs: K1 on the tuned camera raster (back
    # faces culled) and on each of refmode's 3 PCF shadow passes; K2 on a
    # classic render with both culls
    k1, k2 = {}, {}
    calls = capture_all(rt, "cell_raster", lambda: render(tuned_cfg, 0, ftpl))
    cam = [a for a, _ in calls if a[7] == 16]
    if len(cam) != 1:
        fail(f"tuned render: {len(cam)} camera passes")
    k1["tuned camera"] = check_k1(torch, cr, cam[0], "tuned camera, back faces culled", card)
    calls = capture_all(rt, "cell_raster", lambda: render(ref_cfg, 0, rtpl))
    shadow = [a for a, _ in calls if a[7] == 32]
    if len(shadow) != 3:
        fail(f"refmode render: {len(shadow)} shadow passes, expected 3")
    ref_checks = [check_k1(torch, cr, a, f"refmode PCF shadow, light slot {i}", card)
                  for i, a in enumerate(shadow)]
    k1["refmode shadow"] = dict(ref_checks[0], max_abs_err=max(c["max_abs_err"] for c in ref_checks))
    culled = tuned_cfg._replace(raster="classic", shadow_cull=True)
    k2_in = capture(rt, "fine_raster", lambda a, kw: kw["tile"], lambda: render(culled, 0, ftpl))
    if set(k2_in) != {16, 64}:
        fail(f"culled classic render: fine passes at tiles {sorted(k2_in)}")
    for tile, (args, kw) in sorted(k2_in.items()):
        k2[tile], _, _ = check_k2(torch, fr, args, kw, f"classic, both culls, tile {tile}", card)
    # the culled classic render of phase 4's 8 settled poses: K2's launches
    cr.reset_launch_counts()
    fr.reset_launch_counts()
    frames, plain = count_calls(fr, plain_k2, lambda: [render(culled, b, ftpl) for b in range(BATCH)])
    culled_k2 = dict(fr.fine_raster.launches_by_shape)
    for b, f in enumerate(frames):
        check_full_frames(torch, type(f)(*(x[None] for x in f)), f"culled classic scene {b}")
    phase("rungs", f"classic with both culls, {BATCH} renders: K2 launches {culled_k2}, plain calls "
                   f"{plain}")
    if any(plain.values()) or culled_k2.get((16, 1), 0) != BATCH:
        fail(f"culled classic: K2 launches {culled_k2}, plain calls {plain}")
    del frames

    # one render each of the other modes (scene 0 of phase 4)
    base = render(fcfg, 0, ftpl)
    for what, c in (("shadow off, no SSAO", fcfg._replace(shadow_mode="off", ssao=False)),
                    ("flat", fcfg._replace(shading="flat")),
                    ("phong", fcfg._replace(shading="phong"))):
        f = render(c, 0, ftpl)
        check_frames(torch, type(f)(*(x[None] for x in f)), what)
        if what == "phong":
            same = all(torch.equal(getattr(f, n), getattr(base, n)) for n in f._fields)
            phase("rungs", f"phong: every field equal to the pbr frame: {same}")
            if not same:
                fail("the phong frame differs from the pbr frame")
            continue
        d = float((f.hdr[..., :3] - base.hdr[..., :3]).abs().mean())
        phase("rungs", f"{what}: finite; mean |hdr rgb difference| to bench-full {d:.6f}")
        if d <= 0:
            fail(f"{what} changed nothing")
    del base, f

    def entry(name, source, replaces, launches, res):
        return dict(name=name, route="cuda", source=f"stillleben_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, library_ms=None, **res)

    k1_src, k1_at = "cell_raster.cu", "stillleben_tpu/ops/cell_raster.py:43"
    k2_src, k2_at = "fine_raster.cu", "stillleben_tpu/ops/fine_raster.py:98"
    return dict(kernels=[
        entry("cell_raster[tuned camera, back faces culled, tile 16]", k1_src, k1_at,
              out["tuned"]["k1"][16], k1["tuned camera"]),
        entry("cell_raster[refmode PCF shadow, 3 light slots, tile 32]", k1_src, k1_at,
              out["refmode"]["k1"][32], k1["refmode shadow"]),
        entry("fine_raster[classic with both culls, camera, tile 16]", k2_src, k2_at,
              culled_k2[(16, 1)], k2[16]),
        entry("fine_raster[classic with both culls, shadow, tile 64]", k2_src, k2_at,
              culled_k2[(64, 1)], k2[64]),
    ])


API_SEEDS = (0, 1)
API_FIELDS = {  # accessor: (trailing shape, dtype name)
    "rgb": ((4,), "uint8"), "class_index": ((), "uint16"), "instance_index": ((), "uint16"),
    "coordinates": ((3,), "float32"), "depth": ((), "float32"), "coordDepth": ((4,), "float32"),
    "normals": ((4,), "float32"), "vertex_indices": ((3,), "int32"),
    "barycentric_coeffs": ((3,), "float32"), "cam_coordinates": ((4,), "float32"),
}


def check_api_result(torch, result, scene, what: str, plane: bool = True) -> str:
    """A ``RenderPassResult`` at the viewport: every accessor's shape and
    dtype, every float field finite, objects (and with ``plane`` the plane)
    in view."""
    W, H = scene.viewport
    for name, (shape, dtype) in API_FIELDS.items():
        x = getattr(result, name)()
        if tuple(x.shape) != (H, W) + shape or str(x.dtype) != f"torch.{dtype}":
            fail(f"{what}: {name} is {tuple(x.shape)} {x.dtype}, not {(H, W) + shape} {dtype}")
        if x.device.type != "cuda":
            fail(f"{what}: {name} on {x.device}")
        if x.is_floating_point() and not torch.isfinite(x).all():
            fail(f"{what}: non-finite values in {name}")
    inst = result.instance_index().to(torch.int32)
    valid = result.frame.valid
    obj_px, plane_px = int((inst > 0).sum()), int((valid & (inst == 0)).sum())
    if obj_px == 0 or (plane and plane_px == 0):
        fail(f"{what}: {obj_px} object pixels, {plane_px} plane pixels")
    if (result.depth()[~valid] != 3000).any() or (result.vertex_indices()[~valid] != 0).any():
        fail(f"{what}: background pixels without depth 3000 and vertex id 0")
    return (f"{obj_px} object px, {plane_px} plane px, "
            f"{len(torch.unique(inst).tolist()) - 1} instances, rgb std "
            f"{float(result.rgb().float().std()):.2f}")


def run_api(torch, cr, rt, light_map, card) -> tuple:
    """Phase 13: the public host API at 640x480 (see the module docstring).
    Returns the kernels' entries of K1 on this path's inputs, the settled
    scene of seed 0, the seconds of each seed's settle and the function
    that builds a scene of this composition for a seed."""
    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.procedural import checker_texture

    ctx = sl.init()
    if ctx.device.type != "cuda":
        fail(f"sl.init() chose {ctx.device}")
    dense, cube, sphere = load_meshes(subdiv=6, textured=True)
    if not all(type(x) is sl.Mesh for x in (dense, cube, sphere)):
        fail("the API meshes are not sl.Mesh")
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.2)
    sphere.scale_to_bbox_diagonal(0.15)
    checker = sl.Texture2D(checker_texture())

    def api_scene(seed):
        """bench-full through the API: the same 10 objects, sky and plane."""
        rng = np.random.default_rng(7)
        scene = sl.Scene((WIDTH, HEIGHT))
        scene.seed(seed)
        for mesh in [dense, cube, sphere] * 3 + [cube]:
            o = sl.Object(mesh)
            o.metallic, o.roughness = float(rng.random()), float(rng.random())
            scene.add_object(o)
        scene.light_map = light_map
        scene.background_plane_size = np.array([3.0, 3.0], np.float32)
        scene.background_plane_texture = checker
        return scene

    from stillleben_tpu_torch.render import frame as frame_mod
    from stillleben_tpu_torch.render import shadow as shadow_mod

    # (pass, md_tiles given, light slot or None) of every K1 call, in order
    calls = []
    captured = []  # seed 0's first render and peel: (pass, slot, every argument)
    capturing = [False]
    # the light slot whose depth raster is running (None outside one), the
    # next slot of the running shadow pass, and each pass's light count
    in_shadow = [None]
    next_slot = [0]
    pass_lights = []
    orig, orig_shadow = rt.cell_raster, shadow_mod._ortho_rasterize_depth
    orig_maps = frame_mod.render_shadow_maps

    def rec(*a):
        slot = in_shadow[0]
        calls.append(("camera" if slot is None else "shadow", a[3] is not None, slot))
        if capturing[0]:
            captured.append((calls[-1][0], slot, tuple(t.clone() if hasattr(t, "clone") else t
                                                        for t in a)))
        return orig(*a)

    def rec_shadow(*a, **kw):
        # the shadow pass rasterizes its light slots in order, one call each
        in_shadow[0] = next_slot[0]
        next_slot[0] += 1
        try:
            return orig_shadow(*a, **kw)
        finally:
            in_shadow[0] = None

    def rec_maps(atlas, inputs, size, max_lights, *a, **kw):
        next_slot[0] = 0
        out = orig_maps(atlas, inputs, size, max_lights, *a, **kw)
        pass_lights.append((min(inputs.light_directions.shape[0], max_lights), next_slot[0]))
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        n = len(calls)
        return out, time.perf_counter() - t0, n

    per_seed = []
    scenes = []

    def drive():
        for seed in API_SEEDS:
            scene = api_scene(seed)
            _, settle_s, _ = timed(scene.simulate_tabletop_scene)
            rp = sl.RenderPass()
            n0 = len(calls)
            capturing[0] = seed == API_SEEDS[0]
            first, first_s, n1 = timed(lambda: rp.render(scene))
            capturing[0] = False
            warm, warm_s, n2 = timed(lambda: rp.render(scene))
            capturing[0] = seed == API_SEEDS[0]
            peel, peel_s, n3 = timed(lambda: rp.render(scene, depth_peel=warm))
            capturing[0] = False
            ss, ss_s, n4 = timed(lambda: sl.RenderPass(supersample=2).render(scene))
            per_seed.append(dict(seed=seed, settle_s=settle_s, first_ms=1e3 * first_s,
                                 warm_ms=1e3 * warm_s, peel_ms=1e3 * peel_s, ss_ms=1e3 * ss_s,
                                 renders=[calls[n0:n1], calls[n1:n2], calls[n2:n3], calls[n3:n4]],
                                 results=(warm, peel, ss)))
            scenes.append(scene)

    cr.reset_launch_counts()
    rt.cell_raster, shadow_mod._ortho_rasterize_depth = rec, rec_shadow
    frame_mod.render_shadow_maps = rec_maps
    try:
        _, plain_calls = count_calls(
            cr, ("cell_raster_plain", "merge_cells", "cell_raster_reference"), drive)
    finally:
        rt.cell_raster, shadow_mod._ortho_rasterize_depth = orig, orig_shadow
        frame_mod.render_shadow_maps = orig_maps
    torch.cuda.synchronize()
    launches = dict(cr.cell_raster.launches_by_tile)
    for run, scene in zip(per_seed, scenes):
        kinds = []
        for what, rcalls in zip(("render", "warm render", "peel render", "supersample=2 render"),
                                run["renders"]):
            cam = sum(1 for k, md, _ in rcalls if k == "camera" and not md)
            peel_cam = sum(1 for k, md, _ in rcalls if k == "camera" and md)
            shadow = sorted(sl for k, _, sl in rcalls if k == "shadow")
            kinds.append(f"{what}: camera {cam}, shadow {len(shadow)} (light slots {shadow}), "
                         f"peel {peel_cam}")
        warm, peel, ss = run["results"]
        contents = [check_api_result(torch, r, scene, f"api seed {run['seed']} {what}", what != "peel")
                    for r, what in ((warm, "render"), (peel, "peel"), (ss, "supersample=2"))]
        shown = peel.frame.valid & (warm.depth() < 2999.0)
        deeper = float((peel.depth()[shown] > warm.depth()[shown] + 1e-3).float().mean())
        phase("api", f"seed {run['seed']}: {len(scene.objects)} objects + plane, "
                     f"simulate_tabletop_scene {run['settle_s']:.3f} s; RenderPass().render "
                     f"{run['first_ms']:.1f} ms first (atlas build), {run['warm_ms']:.1f} ms warm; "
                     f"depth_peel pass {run['peel_ms']:.1f} ms; supersample=2 "
                     f"{run['ss_ms']:.1f} ms ({card})")
        phase("api", f"seed {run['seed']}: K1 launches per render: {'; '.join(kinds)}")
        phase("api", f"seed {run['seed']}: content: render {contents[0]}; peel {contents[1]}, "
                     f"{int(shown.sum())} px behind the first surface, {deeper:.4f} of them "
                     f"deeper by > 1 mm; supersample=2 {contents[2]}")
        if deeper < 0.5 or shown.sum() == 0:
            fail(f"api seed {run['seed']}: the depth peel did not show the surfaces behind")
        # every object covers pixels when it is the only one drawn
        rp = sl.RenderPass()
        alone = []
        for o in scene.objects:
            r = rp.render(scene, predicate=lambda ob, o=o: ob is o)
            alone.append(int((r.instance_index().to(torch.int32) == o.instance_index).sum()))
        phase("api", f"seed {run['seed']}: pixels of each object drawn alone {alone}; of each "
                     f"in the render {[int((warm.instance_index().to(torch.int32) == o.instance_index).sum()) for o in scene.objects]}")
        if min(alone) == 0:
            fail(f"api seed {run['seed']}: an object covers no pixels: {alone}")
        z = [float(o.pose()[2, 3]) for o in scene.objects]
        if min(z) < 0.0 or max(z) > 2.0:
            fail(f"api seed {run['seed']}: the settle left objects off the table: {z}")
    phase("api", f"K1 launches by tile over the API path {launches}; calls of K1's plain pieces "
                 f"{plain_calls}")
    if any(plain_calls.values()):
        fail(f"the API path on the card called K1's plain pieces: {plain_calls}")
    if not any(k == "camera" for k, _, _ in calls) or not any(k == "shadow" for k, _, _ in calls):
        fail(f"the API path did not launch K1 for camera and shadow: {launches}")

    # K1 against its plain version on the path's own inputs: seed 0's
    # render (camera, the dark light slot 0, the sun in slot 1) and the
    # peel pass's camera raster (md_tiles given)
    cam = [a for k, _, a in captured if k == "camera" and a[3] is None]
    shadow = {}  # each light slot's first call
    for k, slot, a in captured:
        if k == "shadow":
            shadow.setdefault(slot, a)
    peel_cam = [a for k, _, a in captured if k == "camera" and a[3] is not None]
    if len(cam) != 1 or sorted(shadow) != [0, 1] or len(peel_cam) != 1:
        fail(f"api: captured {len(cam)} camera, shadow slots {sorted(shadow)}, "
             f"{len(peel_cam)} peel calls")
    # launches of the API run: the kernel's own counts by tile, split by pass
    # and light slot with the calls recorded above
    n_cam = sum(1 for k, md, _ in calls if k == "camera" and not md)
    n_peel = sum(1 for k, md, _ in calls if k == "camera" and md)
    n_slot = {sl: sum(1 for k, _, s in calls if k == "shadow" and s == sl) for sl in (0, 1)}
    n_shadow = sum(1 for k, _, _ in calls if k == "shadow")
    if (sum(launches.values()) != len(calls) or n_shadow != sum(n_slot.values())
            or any(n != done for n, done in pass_lights)):
        fail(f"api: {launches} launches against {len(calls)} calls, {n_shadow} shadow calls "
             f"({n_slot} by slot), light slots per shadow pass (lights, rasterized) "
             f"{pass_lights}")
    phase("api", f"K1 shadow launches by light slot {n_slot} over {len(pass_lights)} shadow "
                 f"passes")
    entries = []
    for name, args, n in (
        (f"api camera, tile {cam[0][7]}", cam[0], n_cam),
        (f"api shadow, dark light slot 0, tile {shadow[0][7]}", shadow[0], n_slot[0]),
        (f"api shadow, the sky's sun in slot 1, tile {shadow[1][7]}", shadow[1], n_slot[1]),
        (f"api peel pass, camera, tile {peel_cam[0][7]}, md_tiles given", peel_cam[0], n_peel),
    ):
        k = check_k1(torch, cr, args, name, card)
        entries.append(dict(name=f"cell_raster[{name}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43", launches=n,
                            library_ms=None, **k))
    return entries, scenes[0], [run["settle_s"] for run in per_seed], api_scene


REFINE_STEPS = 10
REFINE_DELTA = 0.02  # the start: every pose parameter of every object
REFINE_LR = 0.1  # make_train_step's update (__graft_entry__.py:135)
DESCENT_EPS = 1e-3  # the descent check's step along -grad, unit norm
PLAIN_K1 = ("cell_raster_plain", "merge_cells", "cell_raster_reference")


def run_refine_trainer(torch, cr, rt, tpl, cfg, poses, cam, light, card) -> tuple[list, dict]:
    """Phase 14, the trainer: ``render_with_poses`` under autograd at
    bench-full's settled scene 0 (see the module docstring). Returns the
    K1 inputs of one refinement forward by tile and the run's record."""
    from stillleben_tpu_torch.parallel.batch import render_with_poses
    from test_torch_gpu import refine_loss

    with torch.no_grad():
        target = render_with_poses(tpl, poses, cam, cfg, light).hdr
    nb = poses.shape[0]
    delta0 = torch.full((nb, 6), REFINE_DELTA, device=poses.device)
    # one forward under autograd, its K1 inputs kept (the wrapper refuses
    # inputs that carry a gradient, so these are detached from the graph)
    k1_in = capture(rt, "cell_raster", lambda a, kw: a[7],
                    lambda: refine_loss(tpl, poses, cam, light, cfg, target,
                                        delta0.clone().requires_grad_(True)))
    if set(k1_in) != {16, 32}:
        fail(f"refine: expected a tile-16 camera and a tile-32 shadow K1 call, got {sorted(k1_in)}")
    steps = []

    def loop():
        delta = delta0.clone().requires_grad_(True)
        for _ in range(REFINE_STEPS):
            n0 = dict(cr.cell_raster.launches_by_tile)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, f = refine_loss(tpl, poses, cam, light, cfg, target, delta)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n1 = dict(cr.cell_raster.launches_by_tile)
            (g,) = torch.autograd.grad(loss, delta)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n2 = dict(cr.cell_raster.launches_by_tile)
            steps.append(dict(
                loss=float(loss.detach()), fwd_ms=1e3 * (t1 - t0), bwd_ms=1e3 * (t2 - t1),
                grad=g.detach(), delta=delta.detach().clone(),
                inst=f.instance_index.to(torch.int32) if not steps else None,
                fwd_k1={t: n1.get(t, 0) - n0.get(t, 0) for t in n1},
                bwd_k1=sum(n2.values()) - sum(n1.values())))
            delta = (delta - REFINE_LR * g).detach().requires_grad_(True)

    cr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _, plain_calls = count_calls(cr, PLAIN_K1, loop)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cr.cell_raster.launches_by_tile)
    for i, st in enumerate(steps):
        if not torch.isfinite(st["grad"]).all():
            fail(f"refine step {i}: a gradient is not finite: {st['grad']}")
    g0, inst = steps[0]["grad"], steps[0]["inst"]
    px = [int((inst == i + 1).sum()) for i in range(nb)]
    zero = [i for i in range(nb) if px[i] > 0 and float(g0[i].abs().max()) == 0.0]
    with torch.no_grad():
        lower, _ = refine_loss(tpl, poses, cam, light, cfg, target,
                               steps[0]["delta"] - DESCENT_EPS * g0 / g0.norm())
    fwd = [st["fwd_ms"] for st in steps[1:]]
    bwd = [st["bwd_ms"] for st in steps[1:]]
    per_k1 = [st["fwd_k1"] for st in steps]
    rec = dict(first_fwd_ms=steps[0]["fwd_ms"], first_bwd_ms=steps[0]["bwd_ms"],
               fwd_ms=sum(fwd) / len(fwd), bwd_ms=sum(bwd) / len(bwd), peak=peak,
               launches=launches)
    phase("refine", f"trainer: bench-full scene 0 at {WIDTH}x{HEIGHT}, "
                    f"{tpl.render_atlas.faces.shape[0]} faces, {cfg.shadow_size}^2 VSM, "
                    f"{nb} objects, delta {REFINE_DELTA} on all 6 parameters, {REFINE_STEPS} steps "
                    f"of loss = mean((hdr - target)^2) + 1e-6 |delta|^2, delta -= {REFINE_LR} grad")
    phase("refine", f"trainer: first step forward {rec['first_fwd_ms']:.2f} ms, backward "
                    f"{rec['first_bwd_ms']:.2f} ms; steps 2-{REFINE_STEPS} forward "
                    f"{rec['fwd_ms']:.2f} ms, backward {rec['bwd_ms']:.2f} ms, "
                    f"{rec['fwd_ms'] + rec['bwd_ms']:.2f} ms per iteration, "
                    f"{1e3 / (rec['fwd_ms'] + rec['bwd_ms']):.3f} iterations/s (each ms "
                    f"per step {[round(a + b, 2) for a, b in zip(fwd, bwd)]}) ({card})")
    phase("refine", f"trainer: loss per step {[round(st['loss'], 6) for st in steps]}")
    phase("refine", f"trainer: peak memory {peak / 2**20:.1f} MiB "
                    f"(torch.cuda.max_memory_allocated; {base_mem / 2**20:.1f} MiB allocated "
                    f"before the loop) ({card})")
    phase("refine", f"trainer: K1 launches per step, forward by tile {per_k1}, backward "
                    f"{[st['bwd_k1'] for st in steps]}; over the loop by tile {launches}; calls of "
                    f"K1's plain pieces {plain_calls}")
    g_obj = [round(float(x), 6) for x in g0.abs().amax(1)]
    phase("refine", f"trainer: step 0 |grad| per object {g_obj}, "
                    f"object pixels {px}; a step of {DESCENT_EPS} along -grad (unit norm): loss "
                    f"{steps[0]['loss']:.6f} -> {float(lower):.6f}")
    rec["profile"] = profile_backward(torch, lambda d: refine_loss(tpl, poses, cam, light, cfg,
                                                                   target, d)[0],
                                      steps[-1]["delta"], card)
    if any(plain_calls.values()):
        fail(f"refine: the trainer called K1's plain pieces on the card: {plain_calls}")
    if any(st["bwd_k1"] for st in steps) or any(k.get(16, 0) != 1 or k.get(32, 0) != 1
                                                 for k in per_k1):
        fail(f"refine: expected one camera and one shadow K1 launch per forward and none in the "
             f"backward: {per_k1}")
    if zero:
        fail(f"refine: objects {zero} cover pixels and get an all-zero gradient")
    if not float(lower) < steps[0]["loss"]:
        fail("refine: a step along -grad does not lower the loss")
    return k1_in, rec


def profile_backward(torch, loss_of, delta, card) -> dict:
    """One more refinement step with its backward under ``torch.profiler``:
    the backward's wall time, the device time of its kernels (their sum
    over the wall time is the device's busy share; the rest it idles while
    the host issues ops), its counts of backward functions and kernels, and
    the kernels with the most device time. The forward runs outside the
    profile."""
    from torch.profiler import ProfilerActivity, profile

    delta = delta.clone().requires_grad_(True)
    loss = loss_of(delta)
    acts = [ProfilerActivity.CPU]
    if delta.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        torch.autograd.grad(loss, delta)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # the kernels' own events (device type CUDA), grouped by name
    by_name = {}
    n_kernels = 0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    n_grad_fns = sum(1 for e in prof.events()
                     if e.name.startswith("autograd::engine::evaluate_function"))
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]

    def op_ms(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3

    # the ops behind the device time, with their input shapes (an op's time
    # includes the ops it calls, so a nested op can follow its caller)
    heavy = sorted((e for e in prof.events() if e.name.startswith("aten::") and op_ms(e) > 0),
                   key=op_ms, reverse=True)[:5]
    busy = f"busy {dev_ms / wall_ms:.3f} of the wall time" if n_kernels else "not measured"
    phase("refine", f"trainer: one backward under torch.profiler: {wall_ms:.2f} ms wall, "
                    f"{n_grad_fns} backward functions, {n_kernels} kernels with {dev_ms:.2f} ms "
                    f"of device time ({busy}); most device time: "
                    + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top) + f" ({card})")
    phase("refine", "trainer: the backward's ops with the most device time (inputs' shapes): "
                    + "; ".join(f"{e.name} {op_ms(e):.3f} ms {e.input_shapes}" for e in heavy))
    return dict(wall_ms=wall_ms, device_ms=dev_ms, kernels=n_kernels, grad_fns=n_grad_fns)


def run_refine_reference(torch, cr, rt, scene, card) -> tuple:
    """Phase 14, the reference route: ``sl.diff`` on phase 13's settled API
    scene with ambient light only (see the module docstring). Returns the
    K1 inputs of the peel pass and its launches."""
    import numpy as np

    import stillleben_tpu_torch as sl
    from torch_port_scene import image_loss_grad

    # the diff module's chain takes an object's pose as its camera-frame
    # pose, as the reference's does (its tests put the camera at the
    # origin): the scene is expressed in the camera frame, the image unchanged
    w2c = np.linalg.inv(scene.camera_pose())
    for o in scene.objects:
        o.set_pose(w2c @ o.pose())
    scene.background_plane_pose = w2c @ scene.background_plane_pose
    scene.set_camera_pose(np.eye(4, dtype=np.float32))
    scene.light_map = None
    scene.light_colors = np.zeros((1, 3), np.float32)
    scene.ambient_light = [1.0, 1.0, 1.0]
    scene.manual_exposure = 1.0
    rp = sl.RenderPass(ssao=False)
    gt_r = rp.render(scene)
    gt = gt_r.rgb()[..., :3].float() / 255.0
    inst = gt_r.instance_index().to(torch.int32)
    # the textured dense mesh with the most pixels: texture makes every
    # rotation visible, as the reference test's object
    dense = [i for i, o in enumerate(scene.objects) if o.mesh.class_index == 1]
    idx = max(dense, key=lambda i: int((inst == scene.objects[i].instance_index).sum()))
    obj = scene.objects[idx]
    n_px = int((inst == obj.instance_index).sum())
    T = obj.pose()
    dev = gt.device
    comps, bp_ms = [], []
    for k in range(6):
        delta = torch.zeros(6, device=dev)
        delta[k] = 0.01
        obj.set_pose(sl.diff.apply_pose_delta(torch.from_numpy(T).to(dev), delta).cpu().numpy())
        r = rp.render(scene)
        dl = image_loss_grad(r.rgb()[..., :3].float() / 255.0, gt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = sl.diff.backpropagate_gradient_to_poses(scene, r, dl)
        torch.cuda.synchronize()
        bp_ms.append(1e3 * (time.perf_counter() - t0))
        if g.device != dev or g.shape != (len(scene.objects), 6):
            fail(f"reference: backpropagate_gradient_to_poses gave {g.shape} on {g.device}")
        comps.append(float(g[idx, k]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vi, gv, gc = sl.diff.bp_to_vertices_and_colors(scene, r, dl)
    torch.cuda.synchronize()
    bv_ms = 1e3 * (time.perf_counter() - t0)
    obj.set_pose(T)
    # soft_forward over a 2-layer depth peel: K1's second camera pass
    # takes the floor of the first
    cr.reset_launch_counts()
    peel_calls = []
    orig = rt.cell_raster

    def rec(*a):
        if a[3] is not None:
            peel_calls.append(tuple(t.clone() if hasattr(t, "clone") else t for t in a))
        return orig(*a)

    rt.cell_raster = rec
    try:
        (r0, r1), plain_calls = count_calls(
            cr, PLAIN_K1, lambda: (lambda a: (a, rp.render(scene, depth_peel=a)))(rp.render(scene)))
    finally:
        rt.cell_raster = orig
    peel_launches = len(peel_calls)
    obs = gt.permute(2, 0, 1).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    soft, rgbs, loss_img, loss, svi, sgv, sgc = sl.diff.soft_forward(
        scene, [r0, r1], obs, sl.losses.neg_iou_loss)
    torch.cuda.synchronize()
    sf_ms = 1e3 * (time.perf_counter() - t0)
    signs = ["+" if c > 0 else "-" if c < 0 else "0" for c in comps]
    phase("refine", f"reference: API scene seed {API_SEEDS[0]} at {scene.viewport[0]}x"
                    f"{scene.viewport[1]} in the camera frame, ambient light only, manual "
                    f"exposure 1; object {idx} "
                    f"(textured dense mesh, {n_px} px); the 6-direction test: components "
                    f"{[round(c, 6) for c in comps]}, signs {''.join(signs)}")
    phase("refine", f"reference: backpropagate_gradient_to_poses {sum(bp_ms) / 6:.2f} ms per call "
                    f"({[round(t, 2) for t in bp_ms]}); bp_to_vertices_and_colors {bv_ms:.2f} ms "
                    f"({len(vi)} objects in view, {sum(int(v.numel()) for v in vi)} vertex ids); "
                    f"soft_forward (2 layers, neg_iou_loss) {sf_ms:.2f} ms, loss {loss:.6f} ({card})")
    phase("refine", f"reference: the depth-peel pass launched K1 with the floor {peel_launches} "
                    f"time(s); calls of K1's plain pieces {plain_calls}")
    for what, ts in (("soft", [soft]), ("gradients", sgv + sgc + gv + gc)):
        if not all(bool(torch.isfinite(t).all()) and t.device == dev for t in ts):
            fail(f"reference: non-finite {what} or off the card")
    if any(c <= 0 for c in comps):
        fail(f"reference: wrong descent direction for parameters "
             f"{[k for k, c in enumerate(comps) if c <= 0]}")
    if any(plain_calls.values()) or peel_launches != 1 or len(svi) == 0:
        fail(f"reference: peel launches {peel_launches}, plain calls {plain_calls}, "
             f"{len(svi)} objects in soft_forward")
    return peel_calls[0], peel_launches


LOADER_FORMATS = ("glb", "gltf", "fbx", "dae", "stl", "off", "3ds", "x")
# the procedural OBJ each format was written from (write_loader_fixtures)
LOADER_SOURCES = {"glb": "blob_textured", "gltf": "blob_textured", "fbx": "cube", "dae": "sphere",
                  "stl": "sphere", "off": "sphere", "3ds": "cube", "x": "cube"}


def run_loaders(torch, cr, rt, card) -> tuple[list, dict]:
    """Phase 15: the reference's asset and light-map loading path (see the
    module docstring). Returns the kernels' entries of K1 on this path's
    inputs and the phase's seconds."""
    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import native_decompose
    from stillleben_tpu_torch.assets.image import read_png_samples
    from stillleben_tpu_torch.assets.procedural import (
        checker_texture, write_loader_fixtures, write_meshes,
    )
    from stillleben_tpu_torch.render import light_map as lm_mod

    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    fixtures = os.path.join(build, "loaders")
    t0 = time.perf_counter()
    fx = write_loader_fixtures(fixtures, subdiv=6, seed=0)
    objs = write_meshes(fixtures, subdiv=6, seed=0)
    secs = {"fixtures": time.perf_counter() - t0}
    t0 = time.perf_counter()
    native_decompose.build()
    secs["native build"] = time.perf_counter() - t0
    # hull caches of this run's own, so that every mesh is cooked: the
    # parse and the cooking timed apart (one mesh after another), then the
    # main path's load_threaded with physics
    names = [fx[k] for k in LOADER_FORMATS] + ["primitive://cube", "primitive://sphere"]
    os.environ["STILLLEBEN_TPU_MESH_CACHE"] = os.path.join(build, f"hulls_{os.getpid()}_a")
    t0 = time.perf_counter()
    parsed = sl.Mesh.load_threaded(names, physics=False)
    secs["parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for mesh in parsed:
        mesh.load_physics()
    secs["cooking"] = time.perf_counter() - t0
    os.environ["STILLLEBEN_TPU_MESH_CACHE"] = os.path.join(build, f"hulls_{os.getpid()}_b")
    t0 = time.perf_counter()
    meshes = sl.Mesh.load_threaded(names, physics=True)
    secs["load_threaded"] = time.perf_counter() - t0
    phase("loaders", f"{len(names)} meshes: write_loader_fixtures {secs['fixtures']:.3f} s, "
                     f"the native cooker's g++ build {secs['native build']:.3f} s; "
                     f"load_threaded without physics {secs['parse']:.3f} s, then native cooking "
                     f"one mesh after another {secs['cooking']:.3f} s; load_threaded with "
                     f"physics {secs['load_threaded']:.3f} s ({card})")
    for name, mesh in zip(LOADER_FORMATS + ("primitive://cube", "primitive://sphere"), meshes):
        hulls = mesh._physics.hulls
        phase("loaders", f"{name}: {mesh.consolidated.faces.shape[0]} faces, {len(hulls)} hulls, "
                         f"volume {sum(h.volume for h in hulls):.6f}")
        if not hulls or not all(h.volume > 0 for h in hulls):
            fail(f"loaders: {name} cooked no hull of positive volume")
    for name, mesh in zip(LOADER_FORMATS, meshes):
        ref = sl.Mesh(objs[LOADER_SOURCES[name]], physics=False).consolidated
        got = mesh.consolidated
        a = got.positions[got.faces.astype(np.int64)]
        b = ref.positions[ref.faces.astype(np.int64)]
        # the STL loader welds vertices rounded to 6 decimals
        tol = 5e-7 if name == "stl" else 0.0
        err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
        ok = a.shape == b.shape and err <= tol
        phase("loaders", f"{name} against {os.path.basename(objs[LOADER_SOURCES[name]])}: "
                         f"{a.shape[0]} / {b.shape[0]} triangles, max |corner difference| "
                         f"{err} (tolerance {tol}): {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fail(f"loaders: {name} does not hold the geometry of its OBJ")

    # the light map from its sIBL descriptor, on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    panorama, lights = lm_mod._load_source(fx["ibl"])
    secs["ibl read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    light_map = sl.LightMap(fx["ibl"])
    torch.cuda.synchronize()
    secs["ibl load + precompute"] = time.perf_counter() - t0
    ref = lm_mod.LightMap.from_equirect(
        panorama, lights=list(zip(light_map.light_directions, light_map.light_colors)))
    same = [name for name in lm_mod.LightMapData._fields
            if torch.equal(getattr(light_map.data, name), getattr(ref.data, name))]
    phase("loaders", f"sl.LightMap(sky.ibl) on {light_map.data.cubemap.device}: descriptor and "
                     f"panorama read {secs['ibl read']:.3f} s, load + precompute "
                     f"{secs['ibl load + precompute']:.3f} s; {len(light_map.light_directions)} "
                     f"analytic light(s) {light_map.light_directions.tolist()} colour "
                     f"{light_map.light_colors.tolist()}; LightMapData fields equal to "
                     f"from_equirect of the decoded panorama: {len(same)} of "
                     f"{len(lm_mod.LightMapData._fields)} ({card})")
    if (light_map.data.cubemap.device.type != "cuda" or len(lights) != 1
            or len(same) != len(lm_mod.LightMapData._fields)):
        fail(f"loaders: the .ibl light map is wrong (equal fields {same})")

    # bench-full's composition from the loaded meshes: 3 GLB blobs, 3
    # primitive spheres, 4 cubes (FBX and primitive, alternating)
    by_name = dict(zip(LOADER_FORMATS + ("prim_cube", "prim_sphere"), meshes))
    blob, fbx_cube, cube, sphere = (by_name[k] for k in ("glb", "fbx", "prim_cube", "prim_sphere"))
    blob.center_bbox()
    for i, (mesh, diag) in enumerate(((blob, 0.25), (fbx_cube, 0.2), (cube, 0.2), (sphere, 0.15))):
        mesh.scale_to_bbox_diagonal(diag)
        mesh.class_index = i + 1
    rng = np.random.default_rng(7)
    scene = sl.Scene((WIDTH, HEIGHT))
    scene.seed(SEED)
    for mesh in [blob, fbx_cube, sphere, blob, cube, sphere, blob, fbx_cube, sphere, cube]:
        o = sl.Object(mesh)
        o.metallic, o.roughness = float(rng.random()), float(rng.random())
        scene.add_object(o)
    scene.light_map = light_map
    scene.background_plane_size = np.array([3.0, 3.0], np.float32)
    scene.background_plane_texture = sl.Texture2D(checker_texture())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene.simulate_tabletop_scene()
    torch.cuda.synchronize()
    secs["settle"] = time.perf_counter() - t0

    # one render, every K1 call kept; K1's launches by tile
    def render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sl.RenderPass().render(scene)
        torch.cuda.synchronize()
        secs["render"] = time.perf_counter() - t0
        return out

    result, calls, launches, plain_calls = record_k1(torch, cr, rt, render)
    content = check_api_result(torch, result, scene, "loaders render")
    phase("loaders", f"scene of {len(scene.objects)} loaded objects + plane, {WIDTH}x{HEIGHT}: "
                     f"simulate_tabletop_scene {secs['settle']:.3f} s, RenderPass().render "
                     f"{1e3 * secs['render']:.1f} ms (first: atlas build); K1 launches by tile "
                     f"{launches}; calls of K1's plain pieces {plain_calls}; content: {content} "
                     f"({card})")
    z = [float(o.pose()[2, 3]) for o in scene.objects]
    if min(z) < 0.0 or max(z) > 2.0:
        fail(f"loaders: the settle left objects off the table: {z}")
    cam = [a for k, _, a in calls if k == "camera"]
    shadow = [a for k, _, a in calls if k == "shadow"]
    # the light map's sun takes the free light slot 1: two shadow passes
    if (any(plain_calls.values()) or len(cam) != 1 or len(shadow) != 2
            or sum(launches.values()) != len(calls)):
        fail(f"loaders: K1 calls {len(calls)} (camera {len(cam)}, shadow {len(shadow)}), "
             f"launches {launches}, plain calls {plain_calls}")
    entries = []
    for label, args, n in ((f"loaders camera, tile {cam[0][7]}", cam[0], 1),
                           (f"loaders shadow, dark light slot 0, tile {shadow[0][7]}",
                            shadow[0], 1),
                           (f"loaders shadow, the .ibl sun in slot 1, tile {shadow[1][7]}",
                            shadow[1], 1)):
        k = check_k1(torch, cr, args, label, card)
        entries.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43", launches=n,
                            library_ms=None, **k))

    # save with sl.ImageSaver, read back with the port's decoder
    out_dir = os.path.join(build, f"saved_{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    rgb = result.rgb().cpu().numpy()
    depth_mm = np.clip(np.round(result.depth().cpu().numpy() * 1000.0), 0, 65535).astype(np.uint16)
    arrays = {"rgb.png": rgb, "depth.png": depth_mm,
              "instance.png": result.instance_index().cpu().numpy().astype(np.uint8),
              "class.png": result.class_index().cpu().numpy().astype(np.uint8)}
    t0 = time.perf_counter()
    with sl.ImageSaver() as saver:
        for name, arr in arrays.items():
            saver.save(arr, os.path.join(out_dir, name))
    secs["save"] = time.perf_counter() - t0
    back = {name: read_png_samples(os.path.join(out_dir, name)).samples.reshape(arr.shape)
            for name, arr in arrays.items()}
    same = {name: bool(np.array_equal(back[name], arr) and back[name].dtype == arr.dtype)
            for name, arr in arrays.items()}
    loader = sl.ImageLoader(out_dir, seed=0)
    try:
        textures = [loader.next_texture() for _ in range(4)]
    finally:
        loader.close()
    shapes = sorted({t.pixels.shape for t in textures})
    phase("loaders", f"ImageSaver {len(arrays)} PNGs (RGBA, 16-bit depth in mm, 8-bit instance "
                     f"and class) in {secs['save']:.3f} s; read back bitwise equal: {same}; "
                     f"ImageLoader(seed=0) gave {len(textures)} textures of {shapes}")
    if not all(same.values()) or shapes != [(HEIGHT, WIDTH, 4)]:
        fail("loaders: what ImageSaver wrote does not read back")
    return entries, secs


JOB_SEEDS = (2, 3)
MANIP_STEPS, MANIP_DT = 120, 0.01


def record_k1(torch, cr, rt, run):
    """Run ``run()`` with every K1 call kept (pass, light slot, cloned
    arguments) and K1's plain pieces counted; returns (run's result, the
    calls, the launches by tile, the plain calls)."""
    from stillleben_tpu_torch.render import shadow as shadow_mod

    calls = []
    original, orig_shadow = rt.cell_raster, shadow_mod._ortho_rasterize_depth
    slot = [None, 0]  # the running shadow raster's light slot, the next slot

    def record(*args):
        calls.append(("camera" if slot[0] is None else "shadow", slot[0],
                      tuple(a.clone() if hasattr(a, "clone") else a for a in args)))
        return original(*args)

    def record_shadow(*args, **kwargs):  # one call per light slot, in order
        slot[0] = slot[1]
        slot[1] += 1
        try:
            return orig_shadow(*args, **kwargs)
        finally:
            slot[0] = None

    def run_once():
        slot[1] = 0
        return run()

    cr.reset_launch_counts()
    rt.cell_raster, shadow_mod._ortho_rasterize_depth = record, record_shadow
    try:
        out, plain_calls = count_calls(cr, PLAIN_K1, run_once)
    finally:
        rt.cell_raster, shadow_mod._ortho_rasterize_depth = original, orig_shadow
    torch.cuda.synchronize()
    return out, calls, dict(cr.cell_raster.launches_by_tile), plain_calls


def sync_timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_public_table(torch, cr, rt, scene, serial_settle_s, make_scene, card) -> list:
    """Phase 16: the rest of the public table on phase 13's settled scene
    of seed 0 (see the module docstring), which it leaves as it found it.
    Returns the kernels' entries of K1 on the dashboard's inputs."""
    import json as json_mod
    import urllib.error
    import urllib.request

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.image import decode_png_samples, read_png_samples
    from stillleben_tpu_torch.physics.telemetry import PhysicsTelemetry
    from stillleben_tpu_torch.utils import sanitize

    dev = sl.context().device
    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    W, H = scene.viewport
    saved = ([(o.pose(), o.linear_velocity, o.angular_velocity) for o in scene.objects],
             scene.camera_pose(), scene.manual_exposure)

    # -- the viewer: the dashboard, K1 on its inputs, the scripted session
    viewer = sl.Viewer(scene)
    first, first_s = sync_timed(torch, viewer.dashboard)
    (warm, warm_s), calls, launches, plain_calls = record_k1(
        torch, cr, rt, lambda: sync_timed(torch, viewer.dashboard))
    if (first.shape != (2 * H, 2 * W, 3) or first.dtype != np.uint8
            or not np.array_equal(first, warm)):
        fail(f"viewer: dashboard {first.shape} {first.dtype}, first == warm "
             f"{np.array_equal(first, warm)}")
    cam = [a for k, _, a in calls if k == "camera"]
    shadow = {sl_: a for k, sl_, a in calls if k == "shadow"}
    phase("public table", f"Viewer.dashboard() {first.shape} {first.dtype}: {1e3 * first_s:.1f} ms "
                          f"first (render pass and atlas built), {1e3 * warm_s:.1f} ms warm; K1 "
                          f"launches per dashboard by tile {launches} (camera {len(cam)}, shadow "
                          f"light slots {sorted(shadow)}); calls of K1's plain pieces "
                          f"{plain_calls} ({card})")
    if (any(plain_calls.values()) or len(cam) != 1 or sorted(shadow) != [0, 1]
            or sum(launches.values()) != len(calls)):
        fail(f"viewer: K1 calls {len(calls)}, launches {launches}, plain calls {plain_calls}")
    entries = []
    for label, args, key in (
        (f"dashboard camera, tile {cam[0][7]}", cam[0], ("camera", None)),
        (f"dashboard shadow, dark light slot 0, tile {shadow[0][7]}", shadow[0], ("shadow", 0)),
        (f"dashboard shadow, the sky's sun in slot 1, tile {shadow[1][7]}", shadow[1],
         ("shadow", 1)),
    ):
        k = check_k1(torch, cr, args, label, card)
        entries.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43",
                            launches=sum(1 for kind, slot, _ in calls if (kind, slot) == key),
                            library_ms=None, **k))

    step_s = []
    original_step = viewer.step

    def timed_step():
        _, secs = sync_timed(torch, original_step)
        step_s.append(secs)

    viewer.step = timed_step
    ball_center = viewer._make_arcball().center
    # every event but the space (which only starts the physics) changes the frame
    events = [("drag", (W, H), (int(W * 1.6), H), 5), ("scroll", 2), ("key", "o"), ("key", "m"),
              ("key", "i"), ("key", " "), ("frames", 5)]
    seen, cams = [], []
    frames, script_s = sync_timed(torch, lambda: viewer.play_script(
        events, frame_cb=lambda ev, img: (seen.append(ev[0]), cams.append(scene.camera_pose()))))
    viewer.step = original_step
    R = cams[0][:3, :3]
    rigid = (np.abs(R @ R.T - np.eye(3)).max() < 1e-5 and abs(np.linalg.det(R) - 1) < 1e-5)
    radius = [float(np.linalg.norm(c[:3, 3] - ball_center)) for c in (saved[1], cams[0])]
    differ = [bool((frames[i] != frames[i + 1]).any()) for i in range(len(frames) - 1)]
    z = [float(o.pose()[2, 3]) for o in scene.objects]
    phase("public table", f"play_script {[e[0] for e in events]}: frames after {seen}, "
                          f"{1e3 * script_s:.1f} ms; the drag moved the camera rigidly "
                          f"{rigid} (distance to the arcball's centre {radius[0]:.6f} -> "
                          f"{radius[1]:.6f}); shading {viewer.shading}, ssao "
                          f"{viewer.ssao_enabled}, instances {viewer.show_instances}; "
                          f"sim_iteration {viewer.sim_iteration}: Scene.simulate on {dev} with "
                          f"{len(scene.objects)} objects + plane, "
                          f"{1e3 * sum(step_s) / max(len(step_s), 1):.2f} ms per frame (4 "
                          f"substeps); consecutive frames differ {differ} (the space changes "
                          f"nothing on screen) ({card})")
    if (seen != ["drag", "scroll", "key", "key", "key", "key", "frames"] or not rigid
            or abs(radius[0] - radius[1]) > 1e-4 or np.allclose(cams[0], saved[1], atol=1e-6)
            or viewer.sim_iteration != 5 or len(step_s) != 5 or differ[4] or not all(differ[:4])
            or not differ[5]
            or not all(np.isfinite(z))):
        fail("viewer: the scripted session is wrong")
    os.environ.pop("DISPLAY", None)
    written = []
    original_dashboard = viewer.dashboard
    viewer.dashboard = lambda: written.append(original_dashboard()) or written[-1]
    out_png = os.path.join(build, f"viewer_{os.getpid()}.png")
    viewer.run(out_png)
    viewer.dashboard = original_dashboard
    back = read_png_samples(out_png).samples.reshape(2 * H, 2 * W, 3)
    same_run = len(written) == 1 and np.array_equal(back, written[0])
    again = np.array_equal(viewer.dashboard(), written[0])
    phase("public table", f"Viewer.run({os.path.basename(out_png)}) took the headless branch; the "
                          f"PNG reads back bitwise equal to its dashboard {same_run}; a second "
                          f"dashboard() of the same state equal {again}")
    if not same_run:
        fail("viewer: the PNG of run() does not hold the dashboard")

    # -- the web viewer on 127.0.0.1
    srv = viewer.serve(host="127.0.0.1", port=0, block=False)
    served = []
    viewer.dashboard = lambda: served.append(original_dashboard()) or served[-1]
    try:
        def get(path):
            with urllib.request.urlopen(srv.url.rstrip("/") + path, timeout=120) as r:
                return r.status, r.headers.get("Content-Type", ""), r.read()

        def post(ev):
            req = urllib.request.Request(srv.url + "event", data=json_mod.dumps(ev).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json_mod.loads(r.read())

        page = get("/")
        (_, ctype, png), png_s = sync_timed(torch, lambda: get("/frame.png"))
        frame = decode_png_samples(png).samples.reshape(2 * H, 2 * W, 3)
        frame_ok = len(served) == 1 and np.array_equal(frame, served[0])
        cam0 = scene.camera_pose()
        seq0 = post({"type": "tick"})["seq"]
        post({"type": "drag_start", "x": float(W), "y": float(H)})
        moved = post({"type": "drag", "x": W * 1.3, "y": H * 0.8})
        post({"type": "drag_end"})
        cam_moved = not np.allclose(scene.camera_pose(), cam0)
        ssao0 = viewer.ssao_enabled
        keyed = post({"type": "key", "key": "o"})
        try:
            get("/nope")
            bad = None
        except urllib.error.HTTPError as e:
            bad = e.code
    finally:
        srv.close()
        viewer.dashboard = original_dashboard
    phase("public table", f"web viewer on {srv.url}: GET / {page[0]} {page[1]}; GET /frame.png "
                          f"{ctype}, {len(png)} bytes in {1e3 * png_s:.1f} ms, decodes equal to the "
                          f"dashboard it rendered {frame_ok}; drag POST /event seq {seq0} -> "
                          f"{moved['seq']}, camera moved {cam_moved}; key 'o' ssao {ssao0} -> "
                          f"{viewer.ssao_enabled} (seq {keyed['seq']}); GET /nope {bad}; closed")
    if (page[0] != 200 or b"/frame.png" not in page[2] or ctype != "image/png" or not frame_ok
            or not cam_moved or moved["seq"] <= seq0 or viewer.ssao_enabled == ssao0
            or bad != 404):
        fail("web viewer: a route is wrong")
    # the scene as phase 13 left it
    for o, (pose, lin, ang) in zip(scene.objects, saved[0]):
        o.set_pose(pose)
        o.linear_velocity, o.angular_velocity = lin, ang
    scene.set_camera_pose(saved[1])
    scene.manual_exposure = saved[2]

    # -- sanitize: debug_nans around a dashboard, at a NaN pose; checked
    viewer = sl.Viewer(scene)
    viewer.dashboard()
    with sanitize.debug_nans():
        clean, nan_s = sync_timed(torch, viewer.dashboard)
    o0 = scene.objects[0]
    pose0 = o0.pose()
    bad_pose = pose0.copy()
    bad_pose[0, 3] = np.nan
    o0.set_pose(bad_pose)
    try:
        with sanitize.debug_nans():
            viewer.dashboard()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    finally:
        o0.set_pose(pose0)
    x = torch.arange(64, device=dev)
    checks = {}
    for what, fn in (("int division by zero", lambda: sanitize.checked(lambda a: a // (a % 2))(x)),
                     ("out-of-range gather", lambda: sanitize.checked(
                         lambda a: torch.gather(a, 0, torch.tensor([3, 64], device=dev)),
                         oob=True)(x)),
                     ("out-of-range index", lambda: sanitize.checked(
                         lambda a: a[torch.tensor([-65], device=dev)], oob=True)(x))):
        try:
            fn()
            checks[what] = "not caught"
        except sanitize.CheckError as e:
            checks[what] = str(e)
    torch.cuda.synchronize()
    alive = int(x.sum()) == 2016
    phase("public table", f"sanitize.debug_nans() around one dashboard: raised nothing, "
                          f"{1e3 * nan_s:.1f} ms under the mode; with object 0's pose NaN: "
                          f"{raised!r}; checked: {checks}; the context works after: {alive} "
                          f"({card})")
    if (clean.shape != (2 * H, 2 * W, 3) or raised is None or "aten." not in raised
            or any(v == "not caught" for v in checks.values()) or not alive):
        fail("sanitize: a check is wrong")

    # -- profiling: Timer(sync=) against CUDA events around the same render
    from stillleben_tpu_torch import profiling

    rp = sl.RenderPass()
    rp.render(scene)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    profiling.Timer.enabled = True
    try:
        out = []
        with profiling.Timer("phase 16 profile"):
            with profiling.Timer("render", sync=out):
                start.record()
                out.append(rp.render(scene).rgb())
                end.record()
            timer_ms = 1e3 * profiling._records[-1][2]
            with profiling.Timer("render, no sync"):
                rp.render(scene)
            nosync_ms = 1e3 * profiling._records[-1][2]
    finally:
        profiling.Timer.enabled = False
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    phase("public table", f"profiling.Timer('render', sync=[rgb]) {timer_ms:.3f} ms, CUDA events "
                          f"around the same render {event_ms:.3f} ms; without sync "
                          f"{nosync_ms:.3f} ms (the enqueue)")
    if timer_ms < event_ms:
        fail("profiling: the synchronized Timer read less than the render's device time")

    # -- extension: a small source against the port's sl_decompose.h
    import ctypes

    from stillleben_tpu_torch import extension

    src = os.path.join(build, "ext_probe.cpp")
    with open(src, "w") as f:
        f.write('#include "sl_decompose.h"\n'
                'extern "C" float sl_probe_volume(const float* pts, int n) {\n'
                "  float v[64 * 3], p[64 * 4], vol = 0.f, com[3], inertia[9];\n"
                "  int nv = 0, np_ = 0;\n"
                "  if (sl_convex_hull(pts, n, 64, 64, v, &nv, p, &np_, &vol, com, inertia) != 1)"
                " return -1.f;\n  return vol;\n}\n")
    t0 = time.perf_counter()
    lib = extension.load("sl_probe", [src, os.path.join(extension.include_paths()[0],
                                                        "sl_decompose.cpp")])
    ext_s = time.perf_counter() - t0
    fn = lib.sl_probe_volume
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    fn.restype = ctypes.c_float
    corners = np.array([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)], np.float32)
    vol = fn(corners.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 8)
    phase("public table", f"extension.load: a source including sl_decompose.h from "
                          f"{os.path.relpath(extension.include_paths()[0], ROOT)} and the cooker "
                          f"built by g++ in {ext_s:.3f} s; sl_convex_hull of a unit cube's corners "
                          f"gives volume {vol:.6f}")
    if abs(vol - 1.0) > 1e-5:
        fail("extension: the built function is wrong")

    # -- ManipulationSim with telemetry: test_manipulation_torque_transfer
    mesh = sl.Mesh("primitive://cube")
    mesh.scale_to_bbox_diagonal(0.2)
    mscene = sl.Scene((WIDTH, HEIGHT))
    mscene.gravity = [0.0, 0.0, 0.0]
    pusher, target = sl.Object(mesh), sl.Object(mesh)
    mscene.add_object(pusher)
    tpose = np.eye(4, dtype=np.float32)
    tpose[:3, 3] = [0.18, 0.07, 0.0]
    target.set_pose(tpose)
    mscene.add_object(target)
    sim = sl.ManipulationSim(mscene, pusher, np.eye(4, dtype=np.float32))
    goal = np.eye(4, dtype=np.float32)
    goal[:3, 3] = [0.35, 0.0, 0.0]
    tele = PhysicsTelemetry()
    tele.record(mscene)
    step_s = []
    for _ in range(MANIP_STEPS):
        _, secs = sync_timed(torch, lambda: sim.step(goal, MANIP_DT))
        step_s.append(secs)
        tele.record(mscene)
    spin = float(np.abs(target.angular_velocity).max())
    Rt = target.pose()[:3, :3]
    angle = float(np.arccos(np.clip((np.trace(Rt) - 1) / 2, -1, 1)))
    lock = float(np.abs(pusher.pose()[:3, :3] - np.eye(3)).max())
    summary = tele.summary()
    path = tele.save(os.path.join(build, f"telemetry_{os.getpid()}.jsonl"))
    loaded, loaded_summary = PhysicsTelemetry.load(path)
    end_poses = [o.pose() for o in mscene.objects]
    tele.replay(mscene, 0)
    replay_0 = float(np.abs(target.pose() - tpose).max())
    tele.replay(mscene, len(tele.frames) - 1)
    replay_last = max(float(np.abs(o.pose() - p).max()) for o, p in zip(mscene.objects, end_poses))
    phase("public table", f"ManipulationSim on {mscene.device}: two 0.2 m cubes, gravity 0, goal "
                          f"0.35 m, {MANIP_STEPS} steps of {MANIP_DT} s: target x "
                          f"{target.pose()[0, 3]:.4f} m, spin {spin:.5f} rad/s, angle "
                          f"{angle:.5f} rad; the pusher's rotation off identity by {lock:.2e}; "
                          f"{1e3 * np.mean(step_s[1:]):.2f} ms per step (the first "
                          f"{1e3 * step_s[0]:.1f}) ({card})")
    phase("public table", f"telemetry: summary {summary}; JSONL save/load of {len(loaded)} frames "
                          f"equal {loaded == tele.frames and loaded_summary == summary}; replay of "
                          f"frame 0 puts the target back within {replay_0:.2e}, of the last frame "
                          f"within {replay_last:.2e}")
    if (target.pose()[0, 3] <= 0.20 or not (spin > 1e-3 or angle > 5e-3) or lock > 1e-5
            or loaded != tele.frames or loaded_summary != summary or summary["frames"] != MANIP_STEPS + 1
            or replay_0 > 1e-5 or replay_last > 1e-5):
        fail("manipulation: a property does not hold")

    # -- JobQueue: two scenes of phase 13's composition on two threads
    scenes = [make_scene(seed) for seed in JOB_SEEDS]
    queue = sl.JobQueue(num_threads=2)
    try:
        def pair():
            for s in scenes:
                queue.add_scene(s)
            return [queue.retrieve_scene() for _ in scenes]

        done, pair_s = sync_timed(torch, pair)
    finally:
        queue.close()
    report = []
    for s in scenes:
        P = s.projection_matrix() @ np.linalg.inv(s.camera_pose())
        centers = np.array([o.pose()[:3, 3] for o in s.objects])
        clip = np.c_[centers, np.ones(len(centers))] @ P.T
        ndc = clip[:, :2] / clip[:, 3:]
        z = centers[:, 2]
        finite = all(np.isfinite(o.pose()).all() for o in s.objects)
        in_view = bool((clip[:, 3] > 0).all() and (np.abs(ndc) <= 1).all())
        report.append((finite, float(z.min()), in_view))
        if not finite or z.min() <= 0.0 or z.max() > 2.0 or not in_view:
            fail(f"job queue: scene {JOB_SEEDS[len(report) - 1]}: finite {finite}, z {z.tolist()}, "
                 f"in view {in_view}")
    serial = sum(serial_settle_s) / len(serial_settle_s)
    phase("public table", f"JobQueue(num_threads=2), seeds {JOB_SEEDS}, {len(scenes[0].objects)} "
                          f"objects + plane each: the pair in {pair_s:.3f} s wall against "
                          f"{serial:.3f} s per serial settle in phase 13 (two serial settles "
                          f"over the pair: {2 * serial / pair_s:.2f}x); (finite, lowest z, "
                          f"centres in view) {report} ({card})")
    if {id(s) for s in done} != {id(s) for s in scenes}:
        fail("job queue: the scenes that came back are not the scenes sent")
    return entries


def _as_f64(torch, x):
    return (x.to(torch.int32) if x.dtype == torch.uint16 else x).to(torch.float64)


SCALE_SUB_BATCH = 3  # phase 17's render groups: 3, 3, 2
TWO_PROC_BATCH, TWO_PROC_ITERATIONS = 4, 25  # phase 17's two processes, depth cut from 100


def run_scale_out(torch, cr, fr, rt, full, ftpl, fcfg, fccfg, solver_cfg, phase6, phase6_k1,
                  phase6_s, state, k1, k2, card) -> list:
    """Phase 17: the scale-out layer on the card. Returns the kernels'
    entries of its paths."""
    import numpy as np

    from stillleben_tpu_torch.parallel.batch import (
        SceneDraws, draw_scenes, generate_batch_sharded, generate_from_draws, make_device_mesh,
        render_with_poses, template_from_scene, template_on,
    )
    from stillleben_tpu_torch.render.rasterize import geometry_stage
    from stillleben_tpu_torch.render.shadow import render_shadow_maps
    from test_torch_gpu import scan_rule_split
    import torch_port_dist

    poses, cam, light = state
    entries = []
    plain_k1 = ("cell_raster_plain", "merge_cells", "cell_raster_reference")
    t_phase = time.perf_counter()

    # one-card mesh, phase 6's batch at full width and depth
    mesh = make_device_mesh()
    if mesh.size != 1 or mesh.devices[0] != torch.device("cuda", 0):
        fail(f"make_device_mesh() on this host: {mesh.devices.tolist()}, expected [cuda:0]")
    cr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards, plain_calls = count_calls(cr, plain_k1, lambda: generate_batch_sharded(
        torch.Generator().manual_seed(SEED), BATCH, ftpl, fcfg, solver_cfg, mesh,
        render_sub_batch=SCALE_SUB_BATCH))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cr.cell_raster.launches_by_tile)
    (shard,) = shards
    same = {f: torch.equal(getattr(shard.frames, f).cpu(), getattr(phase6, f))
            for f in phase6._fields}
    phase("scale-out", f"generate_batch_sharded over make_device_mesh() ({mesh.devices.tolist()}), "
                       f"B={BATCH} {WIDTH}x{HEIGHT}, render_sub_batch {SCALE_SUB_BATCH}: rows "
                       f"{shard.rows.start}:{shard.rows.stop} on {shard.device}, {secs:.3f} s, "
                       f"{BATCH / secs:.4f} scenes/s (phase 6, first call: {phase6_s:.3f} s, "
                       f"{BATCH / phase6_s:.4f} scenes/s) ({card}); every field equal to phase "
                       f"6's: {all(same.values())}; K1 launches by tile {launches} (phase 6: "
                       f"{phase6_k1}); calls of K1's plain pieces {plain_calls}")
    if not all(same.values()) or launches != phase6_k1 or any(plain_calls.values()):
        fail(f"the one-card sharded batch differs from phase 6's: {same}, {launches}")
    sharded_launches = launches
    del shards, shard

    # two processes on the one card, one gloo group, a (2, 1) mesh
    directory = os.path.join(ROOT, "stillleben_tpu_torch", "_build", "scale_out")
    job = dict(template=template_on(ftpl, torch.device("cpu")), cfg=fcfg, solver=solver_cfg,
               seed=SEED + 5, batch=TWO_PROC_BATCH, iterations=TWO_PROC_ITERATIONS,
               render_sub_batch=8, device="cuda:0")
    t0 = time.perf_counter()
    out = torch_port_dist.run_processes(job, 2, directory)  # each process refuses collectives
    wall = time.perf_counter() - t0
    nb = ftpl.tabletop_geom.diameter.shape[0]
    draws = draw_scenes(torch.Generator().manual_seed(SEED + 5), TWO_PROC_BATCH, nb)
    whole = generate_from_draws(draws, ftpl, fcfg, solver_cfg, TWO_PROC_ITERATIONS)
    for rank, got in enumerate(out):
        ((rows, device, frames),) = got["shards"]
        sl = slice(*rows)
        ref = generate_from_draws(SceneDraws(*(x[sl] for x in draws)), ftpl, fcfg, solver_cfg,
                                  TWO_PROC_ITERATIONS)
        equal = {f: torch.equal(getattr(frames, f), getattr(ref, f).cpu()) for f in ref._fields}
        in_whole = {f: torch.equal(getattr(frames, f), getattr(whole, f)[sl].cpu())
                    for f in ref._fields}
        worst = max(((float((_as_f64(torch, getattr(frames, f))
                             - _as_f64(torch, getattr(whole, f)[sl].cpu())).abs().max()), f)
                     for f in ref._fields if not in_whole[f]), default=(0.0, None))
        phase("scale-out", f"process {rank} of 2 (gloo, mesh {got['mesh_shape']}, {device}): "
                           f"local_batch_slice {got['rows'][0]}:{got['rows'][1]}, "
                           f"{got['seconds']:.3f} s for its batch; every field equal to the "
                           f"parent's generate_from_draws of rows {rows[0]}:{rows[1]} at B=2: "
                           f"{all(equal.values())}; equal to those rows of the parent's "
                           f"4-scene batch: {all(in_whole.values())} (largest difference "
                           f"{worst[0]:.3g} in {worst[1]}) ({card})")
        if got["rows"] != (2 * rank, 2 * rank + 2) or not all(equal.values()):
            fail(f"process {rank}: rows {got['rows']}, fields equal {equal}")
    phase("scale-out", f"two processes on one card, B={TWO_PROC_BATCH}, {TWO_PROC_ITERATIONS} "
                       f"settle frames: {wall:.3f} s wall from the spawn to both results, no "
                       f"collective called ({card})")
    del whole, out

    # the atlas modes on phase 4's settled scene 0
    def timed_render(t, c):
        render_with_poses(t, poses, cam, c, light)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = render_with_poses(t, poses, cam, c, light)
        torch.cuda.synchronize()
        return f, (time.perf_counter() - t0) * 1e3

    def inputs_of(t):
        otw = t.base_inputs.obj_to_world.clone()
        otw[: poses.shape[0]] = poses
        dirs = t.base_inputs.light_directions.clone()
        dirs[0] = light
        return t.base_inputs._replace(obj_to_world=otw, cam_pose=cam, light_directions=dirs)

    base, base_ms = timed_render(ftpl, fcfg)
    p0 = template_from_scene(full, shadow_proxy_target=0)
    cr.reset_launch_counts()
    calls = capture_all(rt, "cell_raster", lambda: render_with_poses(p0, poses, cam, fcfg, light))
    p0_launches = dict(cr.cell_raster.launches_by_tile)
    off, off_ms = timed_render(p0, fcfg)
    shadow_in = [a for a, _ in calls if a[7] == 32]
    if len(shadow_in) != 1 or p0_launches != {16: 1, 32: 1}:
        fail(f"the proxy-off render launched K1 {p0_launches}")
    n_casters = int(p0.render_atlas.shadow_faces.shape[0])
    entry = check_k1(torch, cr, shadow_in[0], f"proxy-off shadow ({n_casters} casters), tile 32",
                     card)
    maps = [render_shadow_maps(t.render_atlas, inputs_of(t), SHADOW_SIZE, 1)[0]
            for t in (ftpl, p0)]
    map_diff = float((maps[0] - maps[1]).abs().max())
    frame_diff = float((off.hdr - base.hdr).abs().max())
    phase("scale-out", f"shadow_proxy_target=0: {n_casters} shadow casters (default "
                       f"{int(ftpl.render_atlas.shadow_faces.shape[0])}); K1 launches by tile "
                       f"{p0_launches}; shadow map max |difference| to the default's "
                       f"{map_diff:.4g}, hdr {frame_diff:.4g}; {off_ms:.1f} ms per render "
                       f"(default {base_ms:.1f} ms) ({card})")
    if map_diff <= 0 or frame_diff <= 0:
        fail("the full-geometry shadow changed neither the map nor the frame")
    entries.append(dict(
        name=f"cell_raster[scale-out proxy-off shadow, {n_casters} casters, tile 32]",
        route="cuda", source="stillleben_tpu_torch/csrc/cell_raster.cu",
        replaces="stillleben_tpu/ops/cell_raster.py:43", launches=p0_launches[32],
        library_ms=None, **entry))
    del p0, maps, off, calls, shadow_in
    c1 = template_from_scene(full, cull_closedness=1.0)
    culled = fcfg._replace(backface_cull=True)
    f_c1, c1_ms = timed_render(c1, culled)
    f_def, _ = timed_render(ftpl, culled)
    flags = [int(t.render_atlas.face_cullable.sum()) for t in (c1, ftpl)]
    same = all(torch.equal(getattr(f_c1, f), getattr(f_def, f)) for f in f_c1._fields)
    phase("scale-out", f"cull_closedness=1.0 with backface_cull: {flags[0]} cullable faces "
                       f"(0.98: {flags[1]}; the blob's and the cube's closedness is 1.0, the "
                       f"sphere's 0); frame equal to the 0.98 threshold's: {same}; "
                       f"{c1_ms:.1f} ms per render ({card})")
    if flags[0] != flags[1] or not same:
        fail("cull_closedness=1.0 changed the bench scene's cullable faces")
    del c1, f_c1, f_def

    # the scan rule against the fine kernel's, the classic raster
    results = {}
    for rule in ("kernel", "scan"):
        c = fccfg._replace(classic_fine=rule)
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        frame = render_with_poses(ftpl, poses, cam, c, light)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        launched = dict(fr.fine_raster.launches_by_shape)
        _, ms = timed_render(ftpl, c)
        inputs = inputs_of(ftpl)
        geom = geometry_stage(ftpl.render_atlas, inputs, WIDTH, HEIGHT)
        g = rt.rasterize_tiled(geom, ftpl.render_atlas, inputs, WIDTH, HEIGHT, raster="classic",
                               tile_capacity=c.tile_capacity, big_capacity=c.big_capacity,
                               fine_chunk=c.fine_chunk, pixel_stage=c.pixel_stage,
                               classic_fine=rule)
        results[rule] = (frame, ms, peak, g, launched)
    v = geom.pix_hom[ftpl.render_atlas.faces.long()].cpu().numpy()
    (fk, ms_k, peak_k, gk, k2_launches), (fs, ms_s, peak_s, gs, scan_k2) = results.values()
    tk, ts = gk.tri_id.cpu().numpy(), gs.tri_id.cpu().numpy()
    a, b = scan_rule_split(tk, ts, v, v[..., 2])
    agree = torch.from_numpy(tk == ts).to(gk.depth.device) & (gk.tri_id >= 0)
    depth_err = float((gk.depth - gs.depth)[agree].abs().max()) if agree.any() else 0.0
    inst = int((fk.instance_index != fs.instance_index).sum())
    listed = [tuple(int(i) for i in yx) for yx in np.argwhere(b)]
    phase("scale-out", f"classic_fine scan against kernel, bench-full scene 0 at {WIDTH}x"
                       f"{HEIGHT}: instance maps differ on {inst} px; triangle ids on "
                       f"{int((tk != ts).sum())} px: (a) ties and edges {int(a.sum())}, (b) "
                       f"other {int(b.sum())} {listed}; depth max |difference| where the ids "
                       f"agree {depth_err:.3g}; ms per render scan {ms_s:.1f} / kernel "
                       f"{ms_k:.1f}; peak memory above the start scan {peak_s / 2**20:.1f} / "
                       f"kernel {peak_k / 2**20:.1f} MiB; K2 launches per render {k2_launches} "
                       f"(scan: {scan_k2}) ({card})")
    if b.sum() > 1e-4 * tk.size or depth_err > 1e-5 or scan_k2:
        fail("the scan rule disagrees with the fine kernel beyond ties and edges")
    for tile in (16, 64):
        entries.append(dict(
            name=f"fine_raster[scale-out classic_fine kernel frame {'camera' if tile == 16 else 'shadow'}, tile {tile}]",
            route="cuda", source="stillleben_tpu_torch/csrc/fine_raster.cu",
            replaces="stillleben_tpu/ops/fine_raster.py:98",
            launches=k2_launches.get((tile, 1), 0), library_ms=None,
            **k2[("bench-full", tile)]))
    for tile in (16, 32):
        entries.append(dict(
            name=f"cell_raster[scale-out one-card sharded batch {'camera' if tile == 16 else 'shadow'}, tile {tile}]",
            route="cuda", source="stillleben_tpu_torch/csrc/cell_raster.cu",
            replaces="stillleben_tpu/ops/cell_raster.py:43",
            launches=sharded_launches.get(tile, 0), library_ms=None, **k1[("bench-full", tile)]))
    phase("scale-out", f"phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return entries


IMAGE_FORMATS = ("jpeg", "png", "bmp", "tga", "tiff")
STREAM_SIZE, STREAM_SETTLE = (320, 240), 25  # phase 18's ycb stream (settle cut from 100)
LOADER_TEXTURES = 600  # phase 18's ImageLoader count: ~50x its queue and workers' 12


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def image_scene(meshes, light_map, plane_texture):
    """Phases 18 and 19's composition of (blob, GLB blob, cube, sphere):
    the objects scaled, classes 1-4, ten of them with the bench's seeded
    metallic and roughness, the light map and the 3 x 3 m plane."""
    import numpy as np

    import stillleben_tpu_torch as sl

    blob, glb, cb, sp = meshes
    for i, (mesh, diag) in enumerate(((blob, 0.25), (glb, 0.25), (cb, 0.2), (sp, 0.15))):
        if i < 2:
            mesh.center_bbox()
        mesh.scale_to_bbox_diagonal(diag)
        mesh.class_index = i + 1
    rng = np.random.default_rng(7)
    scene = sl.Scene((WIDTH, HEIGHT))
    scene.seed(SEED)
    for mesh in [blob, glb, sp, blob, cb, sp, glb, cb, sp, blob]:
        o = sl.Object(mesh)
        o.metallic, o.roughness = float(rng.random()), float(rng.random())
        scene.add_object(o)
    scene.light_map = light_map
    scene.background_plane_size = np.array([3.0, 3.0], np.float32)
    scene.background_plane_texture = plane_texture
    return scene


def run_image_formats(torch, cr, rt, card) -> tuple[list, dict, tuple]:
    """Phase 18: the image formats of the asset layer (see the module
    docstring). Returns the kernels' entries of K1 on this path's inputs,
    the phase's seconds and milliseconds, and its settled scene's state
    (object poses, camera pose, plane pose) for phase 19."""
    import hashlib
    import shutil

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import bmp, image, jpeg, native_image, tga, tiff
    from stillleben_tpu_torch.assets.image_fixtures import FILES, digests, seeded_images
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture
    from stillleben_tpu_torch.assets.native_build import build_library
    from stillleben_tpu_torch.assets.procedural import write_image_fixtures
    from stillleben_tpu_torch.examples import ycb

    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    fx_dir = os.path.join(build, f"images_{os.getpid()}")
    secs = {}
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731

    # the codec's g++ build on this host, timed into a directory of its own
    # (the package's _build may hold a library already), then the package's
    t0 = time.perf_counter()
    build_library("sl_image", native_image.SOURCE, native_image.HEADER,
                  os.path.join(fx_dir, "codec"), "the native image codec")
    secs["codec build"] = time.perf_counter() - t0
    lib = native_image.build()
    phase("images", f"the native codec's g++ build: {secs['codec build']:.3f} s; the package "
                    f"loads {os.path.relpath(lib, ROOT)}")

    # JPEG held to Pillow's digests; the committed fixtures decoded
    seeded = seeded_images()
    bad = []
    for name, img in seeded.items():
        enc = jpeg.encode_jpeg(img)
        if sha(enc) != digests.JPEG_ENCODE[name]:
            bad.append(f"JPEG encode of {name}")
        if sha(jpeg.decode_jpeg(enc).tobytes()) != digests.JPEG_ENCODE_DECODE[name]:
            bad.append(f"decode of the JPEG of {name}")
    for name in FILES:
        with open(fixture(name), "rb") as f:
            if sha(image.decode_image(f.read(), name).tobytes()) != digests.DECODE[name]:
                bad.append(f"decode of {name}")
    phase("images", f"JPEG (q75, 4:2:0) encodes of the 256x256 texture and the 640x480 seeded "
                    f"image and their decodes, and the decodes of {len(FILES)} fixtures "
                    f"({', '.join(FILES)}), against Pillow 12.1.0's SHA-256 digests: "
                    f"{2 * len(seeded) + len(FILES) - len(bad)} of {2 * len(seeded) + len(FILES)} "
                    f"equal")
    if bad:
        fail(f"images: not Pillow's digests: {bad}")

    # the textured scene's images as JPEG and TGA, each beside its PNG twin
    t0 = time.perf_counter()
    fx = write_image_fixtures(fx_dir, subdiv=6, seed=0)
    secs["fixtures"] = time.perf_counter() - t0
    os.environ["STILLLEBEN_TPU_MESH_CACHE"] = os.path.join(fx_dir, "hulls")
    t0 = time.perf_counter()
    obj_jpg, glb_jpeg, cube, sphere = sl.Mesh.load_threaded(
        [fx["obj_jpg"], fx["glb_jpeg"], "primitive://cube", "primitive://sphere"])
    secs["load"] = time.perf_counter() - t0
    obj_png, glb_png, cube2, sphere2 = sl.Mesh.load_threaded(
        [fx["obj_png"], fx["glb_png"], "primitive://cube", "primitive://sphere"], physics=False)
    t0 = time.perf_counter()
    light_jpg = sl.LightMap(fx["ibl_jpg"])
    torch.cuda.synchronize()
    secs["LightMap(.ibl, JPEG)"] = time.perf_counter() - t0
    light_png = sl.LightMap(fx["ibl_png"])
    with open(fx["plane_tga"], "rb") as f:
        plane = tga.decode_tga(f.read())

    scene = image_scene((obj_jpg, glb_jpeg, cube, sphere), light_jpg, sl.Texture2D(fx["plane_tga"]))
    twin = image_scene((obj_png, glb_png, cube2, sphere2), light_png, sl.Texture2D(plane))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene.simulate_tabletop_scene()
    torch.cuda.synchronize()
    secs["settle"] = time.perf_counter() - t0
    for a, b in zip(scene.objects, twin.objects):
        b.set_pose(a.pose())
    twin.set_camera_pose(scene.camera_pose())
    twin.background_plane_pose = scene.background_plane_pose

    def render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sl.RenderPass().render(scene)
        torch.cuda.synchronize()
        secs["render"] = time.perf_counter() - t0
        return out

    result, calls, launches, plain_calls = record_k1(torch, cr, rt, render)
    content = check_api_result(torch, result, scene, "images render")
    ref = sl.RenderPass().render(twin)
    fields = ("rgb", "depth", "class_index", "instance_index", "normals", "cam_coordinates")
    same = [f for f in fields if torch.equal(getattr(result, f)(), getattr(ref, f)())]
    phase("images", f"scene of {len(scene.objects)} objects at {WIDTH}x{HEIGHT}: the blob's "
                    f"texture from a JPEG (.mtl), a GLB with an embedded JPEG, the plane from a "
                    f"TGA, LightMap(.ibl) whose REFfile is a JPEG; load_threaded "
                    f"{secs['load']:.3f} s, LightMap {secs['LightMap(.ibl, JPEG)']:.3f} s, "
                    f"simulate_tabletop_scene {secs['settle']:.3f} s, RenderPass().render "
                    f"{1e3 * secs['render']:.1f} ms; K1 launches by tile {launches}; calls of "
                    f"K1's plain pieces {plain_calls}; content: {content}; fields torch.equal "
                    f"to the same scene with the decoded arrays (PNG twins, the plane's array): "
                    f"{len(same)} of {len(fields)} ({card})")
    cam = [a for k, _, a in calls if k == "camera"]
    shadow = {sl_: a for k, sl_, a in calls if k == "shadow"}
    per_key = {}
    for k, sl_, _ in calls:
        per_key[(k, sl_)] = per_key.get((k, sl_), 0) + 1
    if len(same) != len(fields):
        fail(f"images: the decoded-texture frame differs from the array-texture frame in "
             f"{sorted(set(fields) - set(same))}")
    if (any(plain_calls.values()) or len(cam) != 1 or sorted(shadow) != [0, 1]
            or set(per_key.values()) != {1} or sum(launches.values()) != len(calls)):
        fail(f"images: K1 calls by (pass, light slot) {per_key}, launches {launches}, plain "
             f"calls {plain_calls}")
    entries = []
    for label, args, key in (
        (f"images camera, tile {cam[0][7]}", cam[0], ("camera", None)),
        (f"images shadow, dark light slot 0, tile {shadow[0][7]}", shadow[0], ("shadow", 0)),
        (f"images shadow, the .ibl sun in slot 1, tile {shadow[1][7]}", shadow[1],
         ("shadow", 1)),
    ):
        k = check_k1(torch, cr, args, label, card)
        entries.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43",
                            launches=per_key[key], library_ms=None, **k))

    # the lossless formats round-trip the texture and this phase's frame
    frame = result.rgb().cpu().numpy()
    depth_mm = np.clip(np.round(result.depth().cpu().numpy() * 1000.0), 0, 65535).astype(np.uint16)
    texture = seeded["texture"]
    arrays = {"texture RGB": texture, "texture RGBA": np.dstack([texture, texture[..., :1]]),
              "texture L": texture[..., 1].copy(), "frame RGB": frame[..., :3].copy(),
              "frame RGBA": frame, "frame L": result.class_index().cpu().numpy().astype(np.uint8)}
    checked, wrong = 0, []
    for name, a in arrays.items():
        rgba = a[..., None].repeat(3, -1) if a.ndim == 2 else a
        if rgba.shape[2] == 3:
            rgba = np.dstack([rgba, np.full(rgba.shape[:2], 255, np.uint8)])
        for fmt, enc in (("BMP", bmp.encode_bmp), ("TGA", tga.encode_tga),
                         ("TIFF", tiff.encode_tiff)):
            back = image.decode_image(enc(a), f"x.{fmt.lower()}")
            want = rgba.copy()
            if fmt == "BMP" and a.ndim == 3 and a.shape[2] == 4:
                want[..., 3] = 255  # Pillow reads a 32-bit BMP back as RGB
            checked += 1
            if not np.array_equal(back, want):
                wrong.append(f"{name} as {fmt}")
    depth_back = tiff.decode_tiff_cv2(tiff.encode_tiff(depth_mm))
    checked += 1
    if not (depth_back.dtype == np.uint16 and np.array_equal(depth_back, depth_mm)):
        wrong.append("the 16-bit depth as TIFF")
    jpg_err = float(np.abs(jpeg.decode_jpeg(jpeg.encode_jpeg(frame[..., :3]))[..., :3].astype(
        np.int64) - frame[..., :3]).mean())
    phase("images", f"round trips through the port's encoders and decoders (BMP, TGA, TIFF of "
                    f"L, RGB and RGBA of the texture and this phase's frame; the depth in mm as "
                    f"16-bit TIFF): {checked - len(wrong)} of {checked} bitwise; the frame's "
                    f"JPEG (q75) mean |error| {jpg_err:.3f}")
    if wrong or not jpg_err < 4:
        fail(f"images: round trips not bitwise: {wrong}, JPEG error {jpg_err}")

    # the codec's times on this host, the 640x480 frame
    rgb_frame = frame[..., :3].copy()
    encoders = {"jpeg": jpeg.encode_jpeg, "png": image.encode_png, "bmp": bmp.encode_bmp,
                "tga": tga.encode_tga, "tiff": tiff.encode_tiff}
    ms = {}
    for fmt in IMAGE_FORMATS:
        data = encoders[fmt](rgb_frame)
        ms[f"{fmt} encode"] = _median_ms(lambda: encoders[fmt](rgb_frame), 9)
        ms[f"{fmt} decode"] = _median_ms(lambda: image.decode_image(data, f"x.{fmt}"), 9)
    phase("images", "codec on the 640x480 frame, median ms of 9 on the card's host: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" ({card})")

    # the run-length decoders (native) on files of this frame that the tests'
    # writers make (the port writes no run-length file), each read back bitwise
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_image_fixtures as writers

    index = result.class_index().cpu().numpy().astype(np.uint8)
    pal = np.random.default_rng(SEED).integers(0, 256, (256, 3)).astype(np.uint8)
    rle = {"tga rle": (writers.tga(writers.tga_rle(rgb_frame[::-1, :, ::-1].reshape(-1, 3), WIDTH),
                                   WIDTH, HEIGHT, 10, 24), "tga", rgb_frame),
           "tiff packbits": (writers.tiff(rgb_frame, 2, compression=32773), "tif", rgb_frame),
           "bmp rle8": (writers.rle8_bmp(index, pal), "bmp", pal[index]),
           "bmp rle4": (writers.rle8_bmp(index, pal[:16], rle4=True), "bmp", pal[index])}
    wrong = []
    for key, (data, ext, want) in rle.items():
        back = image.decode_image(data, f"x.{ext}")
        if not (np.array_equal(back[..., :3], want) and (back[..., 3] == 255).all()):
            wrong.append(key)
        ms[f"{key} decode"] = _median_ms(lambda: image.decode_image(data, f"x.{ext}"), 9)
    phase("images", "run-length decodes of the 640x480 frame (RGB as RLE TGA and PackBits TIFF, "
                    "the class index as RLE8 and RLE4 BMP), median ms of 9 on the card's host: "
                    + ", ".join(f"{k} {ms[k + ' decode']:.3f} ({len(rle[k][0])} bytes)"
                                for k in rle)
                    + f"; {len(rle) - len(wrong)} of {len(rle)} read back bitwise ({card})")
    if wrong:
        fail(f"images: run-length decodes not bitwise: {wrong}")

    # ImageLoader: timed from its construction over every texture taken, far
    # more than its queue (8) and its workers (4) can hold ahead
    loader_dir = os.path.join(fx_dir, "jpegs")
    os.makedirs(loader_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for i in range(16):
        noisy = np.clip(rgb_frame.astype(np.int16) + rng.integers(-8, 9, rgb_frame.shape), 0, 255)
        with open(os.path.join(loader_dir, f"{i:02d}.jpg"), "wb") as f:
            f.write(jpeg.encode_jpeg(noisy.astype(np.uint8)))
    t0 = time.perf_counter()
    loader = sl.ImageLoader(loader_dir, seed=0, num_threads=4)
    try:
        shapes = {loader.next_texture().pixels.shape for _ in range(LOADER_TEXTURES)}
        secs["ImageLoader"] = time.perf_counter() - t0
    finally:
        loader.close()
    ms["ImageLoader images/s"] = LOADER_TEXTURES / secs["ImageLoader"]
    phase("images", f"ImageLoader(num_threads=4) over 16 JPEG 640x480 frames: "
                    f"{ms['ImageLoader images/s']:.1f} images/s ({LOADER_TEXTURES} textures of "
                    f"{sorted(shapes)} in {secs['ImageLoader']:.3f} s from its construction) "
                    f"({card})")

    # the ycb example's stream on the card: PNG and JPEG through ImageSaver
    out_dir = os.path.join(fx_dir, "ycb_stream")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sw, sh = STREAM_SIZE
    written = ycb.run_stream(n_batches=2, batch=8, out_dir=out_dir, width=sw, height=sh,
                             settle_iterations=STREAM_SETTLE)
    secs["ycb stream"] = time.perf_counter() - t0
    unread = []
    for p in written:
        try:
            if p.endswith("_mask.png"):
                ok = image.read_png_samples(p).samples.shape == (sh, sw, 1)
            else:
                ok = image.read_image(p).shape == (sh, sw, 4)
        except Exception as e:  # noqa: BLE001  (listed, then the phase fails)
            ok = str(e)
        if ok is not True:
            unread.append((os.path.basename(p), ok))
    phase("images", f"examples.ycb.run_stream: 2 batches of 8 at {sw}x{sh} ({STREAM_SETTLE} settle "
                    f"frames) in {secs['ycb stream']:.3f} s, {len(written)} files (RGB PNG and "
                    f"JPEG, 16-bit mask PNG), {len(written) - len(unread)} read back by the "
                    f"port's codec ({card})")
    if len(written) != 48 or unread:
        fail(f"images: the ycb stream's files do not read back: {unread}")
    shutil.rmtree(fx_dir, ignore_errors=True)
    settled = ([o.pose() for o in scene.objects], scene.camera_pose(),
               scene.background_plane_pose)
    return entries, {**secs, **ms}, settled


WEBP_LOADER_FRAMES = 16  # phase 19's ImageLoader directory: 8 lossy and 8 lossless copies
TOOL_SEEDS = 24  # settle_fidelity's default (tools/settle_fidelity.py)
VIEWER_SETTLE = 10  # phase 19's viewer_demo settle frames (cut from 100 for time)


def run_webp_tools(torch, cr, rt, card, settled) -> tuple[list, dict, object]:
    """Phase 19: WebP decoding and the tools (see the module docstring).
    ``settled`` is phase 18's settled state. Returns the kernels' entries of
    K1 on this phase's inputs, its seconds and milliseconds, and the render
    of its WebP scene (phase 20 saves it)."""
    import functools
    import hashlib
    import shutil

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import image, native_image, webp
    from stillleben_tpu_torch.assets.image_fixtures import WEBP_FILES, digests
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture
    from stillleben_tpu_torch.assets.native_build import build_library
    from stillleben_tpu_torch.assets.procedural import write_meshes, write_webp_fixtures
    from stillleben_tpu_torch.physics import tabletop
    from stillleben_tpu_torch.tools import align_mesh, display_mesh, settle_fidelity, viewer_demo

    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    fx_dir = os.path.join(build, f"webp_{os.getpid()}")
    secs, ms = {}, {}
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731

    # the decoder's g++ build, timed into a directory of its own
    t0 = time.perf_counter()
    build_library("sl_webp", native_image.WEBP_SOURCE, native_image.WEBP_HEADER,
                  os.path.join(fx_dir, "codec"), "the native WebP decoder")
    secs["webp build"] = time.perf_counter() - t0
    lib = native_image.build_webp()
    phase("webp", f"the WebP decoder's g++ build: {secs['webp build']:.3f} s; the package loads "
                  f"{os.path.relpath(lib, ROOT)}")

    # every committed WebP, both readings, against Pillow's and OpenCV's digests
    bad = []
    for name in WEBP_FILES:
        with open(fixture(name), "rb") as f:
            data = f.read()
        if sha(webp.decode_webp(data, name).tobytes()) != digests.WEBP_DECODE[name]:
            bad.append(f"Pillow's reading of {name}")
        got = webp.decode_webp_cv2(data, name)
        if got is None or sha(np.ascontiguousarray(got).tobytes()) != digests.WEBP_DECODE_CV2[name]:
            bad.append(f"OpenCV's reading of {name}")
    phase("webp", f"{len(WEBP_FILES)} committed WebP files ({', '.join(WEBP_FILES)}), read as "
                  f"Pillow 12.1.0 and OpenCV 5.0.0 read them, against their SHA-256 digests: "
                  f"{2 * len(WEBP_FILES) - len(bad)} of {2 * len(WEBP_FILES)} equal")
    if bad:
        fail(f"webp: not the libraries' digests: {bad}")

    # phase 18's scene with WebP images, at phase 18's settled poses
    t0 = time.perf_counter()
    fx = write_webp_fixtures(fx_dir, subdiv=6)
    secs["fixtures"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    meshes = sl.Mesh.load_threaded([fx["obj_webp"], fx["glb_webp"], "primitive://cube",
                                    "primitive://sphere"], physics=False)
    secs["load"] = time.perf_counter() - t0
    twins = sl.Mesh.load_threaded([fx["obj_png"], fx["glb_png"], "primitive://cube",
                                   "primitive://sphere"], physics=False)
    t0 = time.perf_counter()
    light_webp = sl.LightMap(fx["ibl_webp"])
    torch.cuda.synchronize()
    secs["LightMap(.ibl, WebP)"] = time.perf_counter() - t0
    light_bmp = sl.LightMap(fx["ibl_bmp"])
    with open(fx["plane_webp"], "rb") as f:
        plane = webp.decode_webp(f.read())
    scene = image_scene(meshes, light_webp, sl.Texture2D(fx["plane_webp"]))
    twin = image_scene(twins, light_bmp, sl.Texture2D(plane))
    poses, camera, plane_pose = settled
    for s_ in (scene, twin):
        for o, p in zip(s_.objects, poses):
            o.set_pose(p)
        s_.set_camera_pose(camera)
        s_.background_plane_pose = plane_pose

    def render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sl.RenderPass().render(scene)
        torch.cuda.synchronize()
        secs["render"] = time.perf_counter() - t0
        return out

    result, calls, launches, plain_calls = record_k1(torch, cr, rt, render)
    content = check_api_result(torch, result, scene, "webp render")
    ref = sl.RenderPass().render(twin)
    fields = ("rgb", "depth", "class_index", "instance_index", "normals", "cam_coordinates")
    same = [f for f in fields if torch.equal(getattr(result, f)(), getattr(ref, f)())]
    phase("webp", f"phase 18's scene at its settled poses, {WIDTH}x{HEIGHT}: the blob's texture "
                  f"from a lossy WebP (.mtl), a GLB with an embedded WebP, the plane from a "
                  f"lossless WebP, LightMap(.ibl) whose REFfile is a WebP (OpenCV's reading); "
                  f"load_threaded {secs['load']:.3f} s, LightMap {secs['LightMap(.ibl, WebP)']:.3f} "
                  f"s, RenderPass().render {1e3 * secs['render']:.1f} ms; K1 launches by tile "
                  f"{launches}; calls of K1's plain pieces {plain_calls}; content: {content}; "
                  f"fields torch.equal to the same scene with the decoded arrays (PNG twins of the "
                  f"textures, a BMP twin of the panorama, the plane's array): {len(same)} of "
                  f"{len(fields)} ({card})")
    cam = [a for k, _, a in calls if k == "camera"]
    shadow = {sl_: a for k, sl_, a in calls if k == "shadow"}
    per_key = {}
    for k, sl_, _ in calls:
        per_key[(k, sl_)] = per_key.get((k, sl_), 0) + 1
    if len(same) != len(fields):
        fail(f"webp: the decoded-texture frame differs from the array-texture frame in "
             f"{sorted(set(fields) - set(same))}")
    if (any(plain_calls.values()) or len(cam) != 1 or sorted(shadow) != [0, 1]
            or set(per_key.values()) != {1} or sum(launches.values()) != len(calls)):
        fail(f"webp: K1 calls by (pass, light slot) {per_key}, launches {launches}, plain "
             f"calls {plain_calls}")
    entries = []
    for label, args, key in (
        (f"webp camera, tile {cam[0][7]}", cam[0], ("camera", None)),
        (f"webp shadow, the .ibl sun in slot 1, tile {shadow[1][7]}", shadow[1], ("shadow", 1)),
    ):
        k = check_k1(torch, cr, args, label, card)
        entries.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43",
                            launches=per_key[key], library_ms=None, **k))

    # the decoder's times on this host: the 640x480 frame, lossy and lossless
    for name in ("frame.webp", "frame_lossless.webp"):
        with open(fixture(name), "rb") as f:
            data = f.read()
        ms[f"{name} decode"] = _median_ms(lambda: webp.decode_webp(data, name), 9)
        ms[f"{name} cv2 decode"] = _median_ms(lambda: webp.decode_webp_cv2(data, name), 9)
        ms[f"{name} bytes"] = len(data)
    phase("webp", "decode of the 640x480 frame, median ms of 9 on the card's host: "
                  + ", ".join(f"{n} {ms[n + ' decode']:.3f} (OpenCV's reading "
                              f"{ms[n + ' cv2 decode']:.3f}; {ms[n + ' bytes']} bytes)"
                              for n in ("frame.webp", "frame_lossless.webp")) + f" ({card})")
    loader_dir = os.path.join(fx_dir, "frames")
    os.makedirs(loader_dir, exist_ok=True)
    for i in range(WEBP_LOADER_FRAMES):
        shutil.copyfile(fixture("frame.webp" if i % 2 else "frame_lossless.webp"),
                        os.path.join(loader_dir, f"{i:02d}.webp"))
    t0 = time.perf_counter()
    loader = sl.ImageLoader(loader_dir, seed=0, num_threads=4)
    try:
        shapes = {loader.next_texture().pixels.shape for _ in range(LOADER_TEXTURES)}
        secs["ImageLoader"] = time.perf_counter() - t0
    finally:
        loader.close()
    ms["ImageLoader images/s"] = LOADER_TEXTURES / secs["ImageLoader"]
    phase("webp", f"ImageLoader(num_threads=4) over {WEBP_LOADER_FRAMES} WebP 640x480 frames (8 "
                  f"lossy, 8 lossless): {ms['ImageLoader images/s']:.1f} images/s "
                  f"({LOADER_TEXTURES} textures of {sorted(shapes)} in {secs['ImageLoader']:.3f} s "
                  f"from its construction) ({card})")
    if shapes != {(480, 640, 4)}:
        fail(f"webp: ImageLoader gave textures of {shapes}")

    # settle_fidelity: ref and tuned at the script's 24 seeds x 100 frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lines = []
    results = settle_fidelity.run(["ref", "tuned"], TOOL_SEEDS, "cuda",
                                  out=lambda line: (lines.append(line),
                                                    phase("tools", f"settle_fidelity: {line}")))
    torch.cuda.synchronize()
    secs["settle_fidelity"] = time.perf_counter() - t0
    phase("tools", f"settle_fidelity ref and tuned, {TOOL_SEEDS} seeds x {settle_fidelity.FRAMES} frames "
                   f"(one batch each) in {secs['settle_fidelity']:.3f} s ({card})")
    if len(lines) != 3 or set(results) != {"ref", "tuned"}:
        fail(f"tools: settle_fidelity printed {lines}")
    # the tool's null: ref's two halves of the seeds against each other (no
    # configuration differs, so a FAIL here is the thresholds' sampling noise)
    z, pd = results["ref"]
    half = TOOL_SEEDS // 2
    pd_rows = pd.reshape(TOOL_SEEDS, -1)
    null = settle_fidelity.config_line("ref split", z[half:], pd_rows[half:].ravel(), z[:half],
                                       pd_rows[:half].ravel())
    phase("tools", f"settle_fidelity's null, ref's seeds {half}-{TOOL_SEEDS - 1} against "
                   f"0-{half - 1}: {null}")

    tool_k1 = {}  # tool -> (its K1 calls, launches by tile, plain calls)

    # display_mesh: 4 views at 256 of the textured blob
    blob_path = write_meshes(os.path.join(build, "meshes"), subdiv=6, seed=0)["blob_textured"]
    sheet_path = os.path.join(fx_dir, "display_mesh.png")
    t0 = time.perf_counter()
    sheet, *tool_k1["display_mesh"] = record_k1(
        torch, cr, rt, lambda: display_mesh.main([blob_path, "--views", "4", "--size", "256",
                                                  "--out", sheet_path]))
    secs["display_mesh"] = time.perf_counter() - t0
    back = image.read_png_samples(sheet_path).samples
    phase("tools", f"display_mesh: 4 views at 256 of the 81,920-face blob in "
                   f"{secs['display_mesh']:.3f} s, sheet {tuple(back.shape)} read back equal: "
                   f"{np.array_equal(back, sheet)}; K1 launches by tile "
                   f"{tool_k1['display_mesh'][1]} ({card})")
    if back.shape != (256, 1024, 3) or not np.array_equal(back, sheet) or not sheet.any():
        fail("tools: display_mesh's sheet")

    # viewer_demo at 256, the settle of its scene cut to VIEWER_SETTLE frames
    demo_dir = os.path.join(fx_dir, "viewer_demo")
    full_settle = tabletop.simulate_tabletop
    tabletop.simulate_tabletop = functools.partial(full_settle, iterations=VIEWER_SETTLE)
    t0 = time.perf_counter()
    try:
        frames, *tool_k1["viewer_demo"] = record_k1(
            torch, cr, rt, lambda: viewer_demo.main([demo_dir, "--size", "256"]))
    finally:
        tabletop.simulate_tabletop = full_settle
    secs["viewer_demo"] = time.perf_counter() - t0
    written = sorted(os.listdir(demo_dir))
    phase("tools", f"viewer_demo at 256 ({VIEWER_SETTLE} settle frames, cut from 100 for time): "
                   f"{len(frames)} frames, {len(written)} files in {secs['viewer_demo']:.3f} s; "
                   f"K1 launches by tile {tool_k1['viewer_demo'][1]} ({card})")
    if len(frames) != 12 or len(written) != 13:
        fail(f"tools: viewer_demo wrote {written}")

    # align_mesh: batch (the sidecar written and read back) and one session render
    align_dir = os.path.join(fx_dir, "align")
    os.makedirs(align_dir, exist_ok=True)
    mesh_path = os.path.join(align_dir, "blob.obj")
    shutil.copyfile(write_meshes(os.path.join(build, "meshes"), subdiv=6, seed=0)["blob"],
                    mesh_path)
    t0 = time.perf_counter()
    aligned = align_mesh.main([mesh_path, "--rot-x", "90", "--rot-z", "30", "--scale", "0.5",
                               "--diagonal", "0.3", "--center", "--write"])
    again = sl.Mesh(mesh_path, physics=False)
    sidecar_ok = bool(np.allclose(again.pretransform, aligned.pretransform, atol=1e-6)
                      and abs(again.bbox.diagonal - 0.3) < 1e-4)
    session = align_mesh.AlignSession(again)
    for key in ("x", "shift+right", "up", "+", "c"):
        session.handle_key(key)
    img, *tool_k1["align_mesh"] = record_k1(torch, cr, rt, session.render)
    secs["align_mesh"] = time.perf_counter() - t0
    phase("tools", f"align_mesh: batch (rot-x 90, rot-z 30, scale 0.5, diagonal 0.3, center, "
                   f"write; the sidecar read back by sl.Mesh: {sidecar_ok}) and an AlignSession's "
                   f"keys and render {tuple(img.shape)} in {secs['align_mesh']:.3f} s; K1 "
                   f"launches by tile {tool_k1['align_mesh'][1]} ({card})")
    if not sidecar_ok or img.shape != (480, 480, 3) or not img.any():
        fail("tools: align_mesh")

    for tool, (calls, launches, plain_calls) in tool_k1.items():
        cams = [a for k, _, a in calls if k == "camera"]
        if not cams or any(plain_calls.values()) or sum(launches.values()) != len(calls):
            fail(f"tools: {tool}'s K1 calls {len(calls)}, launches {launches}, plain "
                 f"{plain_calls}")
        label = f"tools {tool} camera, tile {cams[0][7]}"
        k = check_k1(torch, cr, cams[0], label, card)
        entries.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43",
                            launches=launches.get(cams[0][7], 0), library_ms=None, **k))
    shutil.rmtree(fx_dir, ignore_errors=True)
    return entries, {**secs, **ms}, result


def run_webp_encode(card, rendered) -> dict:
    """Phase 20: WebP encoding (see the module docstring). ``rendered`` is
    phase 19's render of its WebP scene. Returns the phase's seconds and
    milliseconds."""
    import hashlib
    import shutil

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import native_image, webp
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture
    from stillleben_tpu_torch.assets.procedural import base_color_texture, sky_ldr

    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_image_fixtures as writers

    fx_dir = os.path.join(ROOT, "stillleben_tpu_torch", "_build", f"webp_enc_{os.getpid()}")
    os.makedirs(fx_dir, exist_ok=True)
    secs, ms = {}, {}

    # the encoder's g++ build (the package's own, into _build; instant on a
    # host that has built this version already)
    t0 = time.perf_counter()
    lib = native_image.build_webp_enc()
    secs["encoder build"] = time.perf_counter() - t0
    phase("webp-enc", f"the WebP encoder's g++ build: {secs['encoder build']:.3f} s "
                      f"({os.path.relpath(lib, ROOT)})")

    def committed(name):
        with open(fixture(name), "rb") as f:
            return f.read()

    # the committed q80 fixtures from their sources (the numpy calls of
    # make_webp_fixtures): Pillow's bytes on the CPU host
    sources = {"q80.webp": writers.smooth(67, 91, 3, 1), "frame.webp": writers.webp_frame(),
               "blob_basecolor.webp": base_color_texture(0)[..., :3], "sky.webp": sky_ldr()}
    equal = [n for n, a in sources.items() if webp.encode_webp(a) == committed(n)]
    frames = [webp.encode_webp(writers.smooth(22, 30, 3, 3)),
              webp.encode_webp(writers.smooth(40, 48, 3, 4))]
    if writers.webp_anim((48, 40), [(6, 8, frames[0]), (0, 0, frames[1])]) == committed("anim.webp"):
        equal.append("anim.webp (its two frames)")
    phase("webp-enc", f"the committed q80 fixtures re-encoded on this host, byte-equal to the "
                      f"files Pillow 12.1.0 wrote: {len(equal)} of {len(sources) + 1} "
                      f"({', '.join(equal)})")
    if len(equal) != len(sources) + 1:
        fail(f"webp-enc: fixtures not re-encoded to Pillow's bytes: {sorted(set(sources) - set(equal))}")

    # the RGBA fixtures: each file (its ALPH chunk libwebp's filter trial and
    # VP8L stream or raw plane) byte-equal to Pillow's and to its SHA-256
    from stillleben_tpu_torch.assets.image_fixtures import digests

    rgba_sources = {"alpha.webp": np.concatenate([writers.smooth(67, 91, 3, 1),
                                                  writers.smooth(67, 91, 1, 2)], -1),
                    **writers.alpha_webp_sources()}
    lines, unequal = [], []
    for name, a in rgba_sources.items():
        ours = webp.encode_webp(a)
        alph = dict(writers.webp_chunks(ours))[b"ALPH"]
        same = (ours == committed(name)
                and hashlib.sha256(ours).hexdigest() == digests.ALPHA_WEBP_FILE[name])
        exact = bool(np.array_equal(webp.decode_webp(ours)[..., 3], a[..., 3]))
        lines.append(f"{name} (ALPH header {alph[0]:#04x}, {len(alph)} bytes): equal {same}, "
                     f"alpha exact {exact}")
        if not (same and exact):
            where = (writers.alph_divergence(ours, committed(name))
                     or writers.vp8_divergence(ours, committed(name)))
            unequal.append(f"{name}: {where}")
    phase("webp-enc", "the RGBA fixtures re-encoded on this host against Pillow 12.1.0's files: "
                      + "; ".join(lines))
    if unequal:
        fail(f"webp-enc: RGBA fixtures not re-encoded to Pillow's bytes: {unequal}")

    # phase 19's render through ImageSaver: RGB, and RGBA with the objects opaque
    rgb = np.ascontiguousarray(rendered.rgb()[..., :3].cpu().numpy())
    mask = np.where(rendered.instance_index().cpu().numpy() > 0, 255, 0).astype(np.uint8)
    rgba = np.ascontiguousarray(np.concatenate([rgb, mask[..., None]], -1))
    paths = {"rgb": os.path.join(fx_dir, "render.webp"), "rgba": os.path.join(fx_dir, "render_rgba.webp")}
    with sl.ImageSaver(num_threads=2) as saver:
        saver.save(rgb, paths["rgb"])
        saver.save(rgba, paths["rgba"])
    data = {k: open(p_, "rb").read() for k, p_ in paths.items()}
    back = {k: webp.decode_webp(d) for k, d in data.items()}

    def psnr(a, where):
        mse = float(np.mean((a[..., :3].astype(np.float64)[where] - rgb[where]) ** 2))
        return 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")

    ms["render RGB PSNR"] = psnr(back["rgb"], mask >= 0)
    ms["render RGBA PSNR on the objects"] = psnr(back["rgba"], mask > 0)
    alpha_back = bool(np.array_equal(back["rgba"][..., 3], mask))
    header = dict(writers.webp_chunks(data["rgba"])).get(b"ALPH", b"?")[:1]
    phase("webp-enc", f"phase 19's render {WIDTH}x{HEIGHT} through sl.ImageSaver: RGB "
                      f"{len(data['rgb'])} bytes, PSNR {ms['render RGB PSNR']:.3f} dB against the "
                      f"render; RGBA (alpha 255 on the {int((mask > 0).sum())} object pixels, 0 "
                      f"elsewhere) {len(data['rgba'])} bytes, ALPH header byte {header.hex()}, "
                      f"alpha read back exact {alpha_back}, PSNR on the objects "
                      f"{ms['render RGBA PSNR on the objects']:.3f} dB")
    if not alpha_back or not min(ms["render RGB PSNR"], ms["render RGBA PSNR on the objects"]) > 20:
        fail(f"webp-enc: the render's round trip (alpha exact {alpha_back}, PSNR "
             f"{ms['render RGB PSNR']:.3f} / {ms['render RGBA PSNR on the objects']:.3f} dB)")

    # the encoder's times on this host
    frame = writers.webp_frame()
    timed = {"frame RGB": frame, "frame RGBA (the render's mask)":
             np.ascontiguousarray(np.concatenate([frame, mask[..., None]], -1)),
             "frame RGBA (a smooth alpha)":
             np.ascontiguousarray(np.concatenate([frame, writers.smooth(480, 640, 1, 1125)], -1)),
             "render RGB": rgb, "render RGBA": rgba}
    for name, a in timed.items():
        ms[f"{name} encode"] = _median_ms(lambda: webp.encode_webp(a), 9)
    phase("webp-enc", "encode of 640x480, median ms of 9 on the card's host: "
                      + ", ".join(f"{n} {ms[n + ' encode']:.3f}" for n in timed) + f" ({card})")
    saver_dir = os.path.join(fx_dir, "saver")
    os.makedirs(saver_dir, exist_ok=True)
    t0 = time.perf_counter()
    with sl.ImageSaver(num_threads=4) as saver:
        for i in range(WEBP_SAVER_FRAMES):
            saver.save(rgba if i % 2 else rgb, os.path.join(saver_dir, f"{i:02d}.webp"))
    secs["ImageSaver"] = time.perf_counter() - t0
    ms["ImageSaver images/s"] = WEBP_SAVER_FRAMES / secs["ImageSaver"]
    written = sorted(os.listdir(saver_dir))
    phase("webp-enc", f"ImageSaver(num_threads=4) over {WEBP_SAVER_FRAMES} frames of the render "
                      f"(RGB and RGBA in turn): {ms['ImageSaver images/s']:.1f} images/s "
                      f"({secs['ImageSaver']:.3f} s from the first save to its close) ({card})")
    if len(written) != WEBP_SAVER_FRAMES or any(
            open(os.path.join(saver_dir, n), "rb").read() != data["rgba" if i % 2 else "rgb"]
            for i, n in enumerate(written)):
        fail(f"webp-enc: ImageSaver(num_threads=4) wrote {written}, not the serial encodes")
    shutil.rmtree(fx_dir, ignore_errors=True)
    return {**secs, **ms}


def run_gif_netpbm(card, rendered) -> dict:
    """Phase 21: GIF and Netpbm encoding (see the module docstring).
    ``rendered`` is phase 19's render of its WebP scene. Returns the
    phase's seconds and milliseconds."""
    import hashlib
    import shutil

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import gif, image, native_image, netpbm
    from stillleben_tpu_torch.assets.image_fixtures import ENCODE_FILES, encode_sources
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture
    from stillleben_tpu_torch.assets.image_fixtures.digests import ENCODE

    fx_dir = os.path.join(ROOT, "stillleben_tpu_torch", "_build", f"gif_enc_{os.getpid()}")
    os.makedirs(fx_dir, exist_ok=True)
    secs, ms = {}, {}

    t0 = time.perf_counter()
    lib = native_image.build_gif_enc()
    secs["encoder build"] = time.perf_counter() - t0
    phase("gif+pnm", f"the GIF encoder's g++ build: {secs['encoder build']:.3f} s "
                     f"({os.path.relpath(lib, ROOT)})")

    # the committed encode fixtures from their sources: Pillow's bytes on the CPU host
    sources, equal = encode_sources(), []
    for name in ENCODE_FILES:
        with open(fixture(name), "rb") as f:
            data = f.read()
        enc = gif.encode_gif if name.endswith(".gif") else netpbm.encode_netpbm
        if hashlib.sha256(data).hexdigest() == ENCODE[name] and enc(sources[name]) == data:
            equal.append(name)
    phase("gif+pnm", f"the committed encode fixtures re-encoded on this host, byte-equal to the "
                     f"files Pillow 12.1.0 wrote: {len(equal)} of {len(ENCODE_FILES)} "
                     f"({', '.join(equal)})")
    if len(equal) != len(ENCODE_FILES):
        fail(f"gif+pnm: fixtures not re-encoded to Pillow's bytes: "
             f"{sorted(set(ENCODE_FILES) - set(equal))}")

    # phase 19's render through ImageSaver as GIF: RGB, and RGBA with the objects opaque
    rgb = np.ascontiguousarray(rendered.rgb()[..., :3].cpu().numpy())
    mask = np.where(rendered.instance_index().cpu().numpy() > 0, 255, 0).astype(np.uint8)
    rgba = np.ascontiguousarray(np.concatenate([rgb, mask[..., None]], -1))
    depth_mm = np.clip(np.round(rendered.depth().cpu().numpy() * 1000.0), 0, 65535).astype(np.uint16)
    arrays = {"rgb": rgb, "rgba": rgba, "depth": depth_mm}
    paths = {"rgb": os.path.join(fx_dir, "render.gif"),
             "rgba": os.path.join(fx_dir, "render_rgba.gif"),
             "depth": os.path.join(fx_dir, "depth_mm.pgm")}
    with sl.ImageSaver(num_threads=3) as saver:
        for k, a in arrays.items():
            saver.save(a, paths[k])
    data = {}
    for k, p_ in paths.items():
        with open(p_, "rb") as f:
            data[k] = f.read()
    ok = True
    for k in ("rgb", "rgba"):
        index, palette, transparency = gif.gif_index(arrays[k])
        back = image.read_image(paths[k])
        same = bool(np.array_equal(back[..., :3], palette[index]))
        where = mask > 0 if k == "rgba" else mask >= 0  # RGBA: the objects' pixels
        mse = float(np.mean((back[..., :3].astype(np.float64)[where] - rgb[where]) ** 2))
        ms[f"render GIF {k} PSNR"] = 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")
        ms[f"render GIF {k} colours"] = len(palette)
        line = (f"phase 19's render {WIDTH}x{HEIGHT} through sl.ImageSaver as GIF {k}: "
                f"{len(data[k])} bytes, {len(palette)} colours, read back equal to the port's "
                f"palette at its index image {same}, PSNR {ms[f'render GIF {k} PSNR']:.3f} dB "
                f"against the render{' on the objects' if k == 'rgba' else ''}")
        if k == "rgba":
            clear = bool(np.array_equal(back[..., 3] == 0, mask == 0))
            line += (f"; transparent index {transparency}, the transparent pixels exactly the "
                     f"{int((mask == 0).sum())} background pixels {clear}")
            same = same and clear
        phase("gif+pnm", line)
        ok = ok and same and ms[f"render GIF {k} PSNR"] > 20
    cv_back = image.read_image_cv2(paths["depth"])
    pil_back = image.read_image(paths["depth"])
    depth_cv = bool(cv_back.dtype == np.uint16 and np.array_equal(cv_back, depth_mm))
    depth_pil = bool(np.array_equal(pil_back[..., 0], np.minimum(depth_mm, 255))
                     and (pil_back[..., 3] == 255).all())
    phase("gif+pnm", f"the render's depth in mm ({int(depth_mm.min())}..{int(depth_mm.max())}) "
                     f"as a 16-bit PGM through sl.ImageSaver: {len(data['depth'])} bytes, read "
                     f"back bitwise in OpenCV's reading {depth_cv}, clipped at 255 in Pillow's "
                     f"{depth_pil}")
    if not (ok and depth_cv and depth_pil):
        fail("gif+pnm: the render's round trip through GIF and PGM")

    # the encoders' times on this host
    timed = {"GIF RGB": lambda: gif.encode_gif(rgb), "GIF RGBA": lambda: gif.encode_gif(rgba),
             "PGM 16-bit": lambda: netpbm.encode_netpbm(depth_mm)}
    for name, fn in timed.items():
        ms[f"{name} encode"] = _median_ms(fn, 9)
    phase("gif+pnm", f"encode of the {WIDTH}x{HEIGHT} render, median ms of 9 on the card's host: "
                     + ", ".join(f"{n} {ms[n + ' encode']:.3f}" for n in timed) + f" ({card})")
    saver_dir = os.path.join(fx_dir, "saver")
    os.makedirs(saver_dir, exist_ok=True)
    t0 = time.perf_counter()
    with sl.ImageSaver(num_threads=4) as saver:
        for i in range(GIF_SAVER_FRAMES):
            saver.save(rgba if i % 2 else rgb, os.path.join(saver_dir, f"{i:02d}.gif"))
    secs["ImageSaver"] = time.perf_counter() - t0
    ms["ImageSaver images/s"] = GIF_SAVER_FRAMES / secs["ImageSaver"]
    written = sorted(os.listdir(saver_dir))
    phase("gif+pnm", f"ImageSaver(num_threads=4) over {GIF_SAVER_FRAMES} GIF frames of the render "
                     f"(RGB and RGBA in turn): {ms['ImageSaver images/s']:.1f} images/s "
                     f"({secs['ImageSaver']:.3f} s from the first save to its close) ({card})")
    if len(written) != GIF_SAVER_FRAMES or any(
            open(os.path.join(saver_dir, n), "rb").read() != data["rgba" if i % 2 else "rgb"]
            for i, n in enumerate(written)):
        fail(f"gif+pnm: ImageSaver(num_threads=4) wrote {written}, not the serial encodes")
    shutil.rmtree(fx_dir, ignore_errors=True)
    return {**secs, **ms}


def run_plain_formats(card, rendered) -> dict:
    """Phase 22: QOI, SGI, PCX/DCX, IM and DDS (see the module docstring).
    ``rendered`` is phase 19's render of its WebP scene. Returns the
    phase's seconds and milliseconds."""
    import contextlib
    import hashlib
    import io
    import shutil

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import dds, image, im, native_image, pcx, qoi, sgi
    from stillleben_tpu_torch.assets.image_fixtures import (PLAIN_ENCODE_FILES, PLAIN_READ_FILES,
                                                            plain_sources)
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture
    from stillleben_tpu_torch.assets.image_fixtures.digests import PLAIN_DECODE, PLAIN_FILE

    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_image_fixtures as writers

    fx_dir = os.path.join(ROOT, "stillleben_tpu_torch", "_build", f"plain_{os.getpid()}")
    os.makedirs(fx_dir, exist_ok=True)
    secs, ms = {}, {}

    t0 = time.perf_counter()
    lib = native_image.build_plain()
    secs["core build"] = time.perf_counter() - t0
    phase("plain", f"the QOI/PCX/SGI/DDS core's g++ build: {secs['core build']:.3f} s "
                   f"({os.path.relpath(lib, ROOT)})")

    # the committed fixtures: re-encoded from their sources, and decoded to
    # the digests of Pillow's readings on the CPU host
    encoders = {".qoi": lambda a, p_: qoi.encode_qoi(a), ".pcx": lambda a, p_: pcx.encode_pcx(a),
                ".dds": lambda a, p_: dds.encode_dds(a), ".im": im.encode_im,
                **{e: sgi.encode_sgi for e in (".sgi", ".rgb", ".rgba", ".bw")}}
    equal, read = [], []
    for name, a in plain_sources().items():
        with open(fixture(name), "rb") as f:
            data = f.read()
        if (hashlib.sha256(data).hexdigest() == PLAIN_FILE[name]
                and encoders[os.path.splitext(name)[1]](a, name) == data):
            equal.append(name)
    for name in PLAIN_ENCODE_FILES + PLAIN_READ_FILES:
        if hashlib.sha256(image.read_image(fixture(name)).tobytes()).hexdigest() == PLAIN_DECODE[name]:
            read.append(name)
    phase("plain", f"the committed encode fixtures re-encoded on this host, byte-equal to the "
                   f"files Pillow 12.1.0 wrote: {len(equal)} of {len(PLAIN_ENCODE_FILES)}; every "
                   f"fixture decoded to the digest of Pillow's reading: {len(read)} of "
                   f"{len(PLAIN_ENCODE_FILES) + len(PLAIN_READ_FILES)} (BC1-BC7 among them)")
    if len(equal) != len(PLAIN_ENCODE_FILES) or len(read) != len(PLAIN_ENCODE_FILES) + len(
            PLAIN_READ_FILES):
        fail(f"plain: fixtures not Pillow's: encode {sorted(set(PLAIN_ENCODE_FILES) - set(equal))}, "
             f"decode {sorted(set(PLAIN_ENCODE_FILES + PLAIN_READ_FILES) - set(read))}")

    # phase 19's render through ImageSaver in the five formats
    rgb = np.ascontiguousarray(rendered.rgb()[..., :3].cpu().numpy())
    mask = np.where(rendered.instance_index().cpu().numpy() > 0, 255, 0).astype(np.uint8)
    rgba = np.ascontiguousarray(np.concatenate([rgb, mask[..., None]], -1))
    depth_mm = np.clip(np.round(rendered.depth().cpu().numpy() * 1000.0), 0, 65535).astype(np.uint16)
    jobs = [(f"render{ext}", rgb) for ext in PLAIN_EXTS]
    jobs += [(f"render_rgba{ext}", rgba) for ext in PLAIN_EXTS] + [("depth_mm.im", depth_mm)]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), sl.ImageSaver(num_threads=4) as saver:
        for name, a in jobs:
            saver.save(a, os.path.join(fx_dir, name))
    written = sorted(os.listdir(fx_dir))
    opaque = np.concatenate([rgb, np.full_like(mask[..., None], 255)], -1)
    wrong = []
    for name, a in jobs:
        p_ = os.path.join(fx_dir, name)
        if name == "render_rgba.pcx":
            if os.path.exists(p_) or f"failed to write {p_}" not in printed.getvalue():
                wrong.append(name)
            continue
        back = image.read_image(p_) if os.path.exists(p_) else None
        want = (np.repeat(np.minimum(a, 255).astype(np.uint8)[..., None], 3, -1) if a is depth_mm
                else a if a.shape[-1] == 4 else opaque[..., :3])
        if back is None or not np.array_equal(back[..., : want.shape[-1]], want) or (
                want.shape[-1] == 3 and not (back[..., 3] == 255).all()):
            wrong.append(name)
        elif image.read_image_cv2(p_) is not None:
            wrong.append(f"{name} (read_image_cv2)")
    sizes = ", ".join(f"{n} {os.path.getsize(os.path.join(fx_dir, n))}" for n in written)
    phase("plain", f"phase 19's render {WIDTH}x{HEIGHT} through sl.ImageSaver (RGB, RGBA with "
                   f"alpha 255 on the {int((mask > 0).sum())} object pixels, depth in mm "
                   f"{int(depth_mm.min())}..{int(depth_mm.max())} as 16-bit IM): bytes {sizes}; "
                   f"read back bitwise (depth clipped at 255 as Pillow reads it), OpenCV's None, "
                   f"RGBA as PCX refused and not written: {not wrong}")
    if wrong:
        fail(f"plain: the render's round trips: {wrong}")

    # the codec's times on this host
    for ext in PLAIN_EXTS:
        name = os.path.join(fx_dir, f"render{ext}")
        enc = encoders[ext]
        ms[f"{ext} encode"] = _median_ms(lambda: enc(rgb, name), 9)
        with open(name, "rb") as f:
            data = f.read()
        ms[f"{ext} decode"] = _median_ms(lambda: image.decode_image(data, name), 9)
    blocks = writers.bcn_blocks(WIDTH, HEIGHT, 16, 22)
    bc7 = writers.dds_file(WIDTH, HEIGHT, 0x4, blocks, dxgi=98)
    ms["BC7 decode"] = _median_ms(lambda: dds.decode_dds(bc7), 9)
    phase("plain", f"the {WIDTH}x{HEIGHT} render, median ms of 9 on the card's host: "
                   + ", ".join(f"{e[1:].upper()} encode {ms[e + ' encode']:.3f} decode "
                               f"{ms[e + ' decode']:.3f}" for e in PLAIN_EXTS)
                   + f"; BC7 decode of {WIDTH}x{HEIGHT} random blocks {ms['BC7 decode']:.3f} "
                     f"({card})")
    shutil.rmtree(fx_dir, ignore_errors=True)
    return {**secs, **ms}


JPEG_DECODE_REPS = 9  # phase 23's median of the 640x480 decodes


def run_jpeg_variants(torch, cr, rt, card, settled) -> tuple[list, dict]:
    """Phase 23: the JPEG variants of the native decoder (see the module
    docstring). ``settled`` is phase 18's settled state. Returns the
    kernels' entries of K1 on this phase's inputs and its milliseconds."""
    import hashlib
    import shutil

    import numpy as np

    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets import image, jpeg
    from stillleben_tpu_torch.assets.image_fixtures import JPEG_VARIANT_FILES, JPEG_VARIANT_FRAMES
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture
    from stillleben_tpu_torch.assets.image_fixtures.digests import (JPEG_VARIANT_DECODE,
                                                                    JPEG_VARIANT_DECODE_CV2,
                                                                    JPEG_VARIANT_FILE)
    from stillleben_tpu_torch.assets.procedural import write_jpeg_variant_fixtures
    from stillleben_tpu_torch.render import light_map as plm

    refusals = ("cannot identify image file", "broken data stream when reading image file",
                "image file is truncated")
    sha = lambda b: hashlib.sha256(b).hexdigest()  # noqa: E731
    fx_dir = os.path.join(ROOT, "stillleben_tpu_torch", "_build", f"jpegvar_{os.getpid()}")
    ms = {}

    # every committed variant, both readings, against Pillow's and OpenCV's digests
    bad, kinds = [], {"read": 0, "refused": 0, "OpenCV only": 0}
    for name in JPEG_VARIANT_FILES:
        with open(fixture(name), "rb") as f:
            data = f.read()
        if sha(data) != JPEG_VARIANT_FILE[name]:
            bad.append(f"the bytes of {name}")
        try:
            got = sha(image.decode_image(data, name).tobytes())
        except OSError as e:
            got = "refused: " + next((r for r in refusals if r in str(e)), str(e))
        except Exception as e:  # noqa: BLE001  (listed, then the phase fails)
            got = f"{type(e).__name__}: {e}"
        if got != JPEG_VARIANT_DECODE[name]:
            bad.append(f"Pillow's reading of {name}: {got[:60]}")
        have = image.read_image_cv2(fixture(name))
        have = "None" if have is None else sha(np.ascontiguousarray(have).tobytes())
        if have != JPEG_VARIANT_DECODE_CV2[name]:
            bad.append(f"OpenCV's reading of {name}")
        ref = JPEG_VARIANT_DECODE[name]
        kinds["read" if not ref.startswith("refused") else
              "OpenCV only" if JPEG_VARIANT_DECODE_CV2[name] != "None" else "refused"] += 1
    phase("jpeg-variants", f"{len(JPEG_VARIANT_FILES)} committed JPEG variants (arithmetic, "
                           f"lossless, CMYK/YCCK, block-smoothed, refused) read as Pillow 12.1.0 "
                           f"and OpenCV 5.0.0 read them, against their SHA-256 digests: "
                           f"{2 * len(JPEG_VARIANT_FILES) - len(bad)} of "
                           f"{2 * len(JPEG_VARIANT_FILES)} equal ({kinds['read']} read by both, "
                           f"{kinds['OpenCV only']} by OpenCV only, {kinds['refused']} refused "
                           f"by both)")
    if bad:
        fail(f"jpeg-variants: not the libraries' digests: {bad}")

    # the decoder's times on this host: the 640x480 frame in each variant
    # and, for the same content, a baseline Huffman file (the port's q75)
    with open(fixture("frame_arith.jpg"), "rb") as f:
        pixels = jpeg.decode_jpeg(f.read())[..., :3].copy()
    frames = {"baseline (Huffman, q75 4:2:0)": jpeg.encode_jpeg(pixels)}
    for name in JPEG_VARIANT_FRAMES:
        with open(fixture(name), "rb") as f:
            frames[name] = f.read()
    # in turns, file after file, so that the host's drift falls on every file
    runs = {(name, how): [] for name in frames for how in ("", " cv2")}
    for rep in range(JPEG_DECODE_REPS + 1):
        for (name, how), times in runs.items():
            fn = jpeg.decode_jpeg_cv2 if how else jpeg.decode_jpeg
            t0 = time.perf_counter()
            fn(frames[name], name)
            if rep:  # the first round warms up
                times.append((time.perf_counter() - t0) * 1e3)
    for (name, how), times in runs.items():
        ms[f"{name}{how} decode"] = sorted(times)[len(times) // 2]
    phase("jpeg-variants", f"decode of the 640x480 frame, median ms of {JPEG_DECODE_REPS} in turns "
                           "on the card's host (Pillow's reading; OpenCV's): "
                           + ", ".join(f"{n} {ms[n + ' decode']:.3f} ({ms[n + ' cv2 decode']:.3f}; "
                                       f"{len(d)} bytes)" for n, d in frames.items())
                           + f" ({card})")

    # phase 18's scene with its images as variants, at phase 18's settled poses
    t0 = time.perf_counter()
    fx = write_jpeg_variant_fixtures(fx_dir, subdiv=6)
    meshes = sl.Mesh.load_threaded([fx["obj_arith"], fx["glb_cmyk"], "primitive://cube",
                                    "primitive://sphere"], physics=False)
    twins = sl.Mesh.load_threaded([fx["obj_png"], fx["glb_png"], "primitive://cube",
                                   "primitive://sphere"], physics=False)
    panorama = plm._load_hdr_image(os.path.join(fx_dir, "sky_ycck.jpg"))
    same_panorama = np.array_equal(panorama, plm._load_hdr_image(
        os.path.join(fx_dir, "sky_ycck.png")))
    light = sl.LightMap(fx["ibl_ycck"])
    torch.cuda.synchronize()
    ms["load and LightMap"] = (time.perf_counter() - t0) * 1e3
    scene = image_scene(meshes, light, sl.Texture2D(fx["plane_lossless"]))
    twin = image_scene(twins, light, sl.Texture2D(fx["plane_png"]))
    poses, camera, plane_pose = settled
    for s_ in (scene, twin):
        for o, p in zip(s_.objects, poses):
            o.set_pose(p)
        s_.set_camera_pose(camera)
        s_.background_plane_pose = plane_pose

    def render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sl.RenderPass().render(scene)
        torch.cuda.synchronize()
        ms["render"] = (time.perf_counter() - t0) * 1e3
        return out

    result, calls, launches, plain_calls = record_k1(torch, cr, rt, render)
    content = check_api_result(torch, result, scene, "jpeg-variants render")
    ref = sl.RenderPass().render(twin)
    fields = ("rgb", "depth", "class_index", "instance_index", "normals", "cam_coordinates")
    same = [f for f in fields if torch.equal(getattr(result, f)(), getattr(ref, f)())]
    phase("jpeg-variants", f"phase 18's scene at its settled poses, {WIDTH}x{HEIGHT}: the blob's "
                           f"texture from an arithmetic progressive JPEG (.mtl), a GLB with an "
                           f"embedded Adobe CMYK JPEG, the plane from a lossless JPEG, "
                           f"LightMap(.ibl) whose REFfile is a YCCK JPEG (OpenCV's reading; the "
                           f"panorama equal to its PNG twin's: {same_panorama}); meshes and "
                           f"LightMap {ms['load and LightMap']:.1f} ms, RenderPass().render "
                           f"{ms['render']:.1f} ms; K1 launches by tile {launches}; calls of K1's "
                           f"plain pieces {plain_calls}; content: {content}; fields torch.equal "
                           f"to the same scene from the PNG twins: {len(same)} of {len(fields)} "
                           f"({card})")
    cam = [a for k, _, a in calls if k == "camera"]
    shadow = {sl_: a for k, sl_, a in calls if k == "shadow"}
    per_key = {}
    for k, sl_, _ in calls:
        per_key[(k, sl_)] = per_key.get((k, sl_), 0) + 1
    if len(same) != len(fields) or not same_panorama:
        fail(f"jpeg-variants: the variant-textured frame differs from its twins' in "
             f"{sorted(set(fields) - set(same))}, panorama equal {same_panorama}")
    if (any(plain_calls.values()) or len(cam) != 1 or sorted(shadow) != [0, 1]
            or set(per_key.values()) != {1} or sum(launches.values()) != len(calls)):
        fail(f"jpeg-variants: K1 calls by (pass, light slot) {per_key}, launches {launches}, "
             f"plain calls {plain_calls}")
    entries = []
    for label, args, key in (
        (f"jpeg variants camera, tile {cam[0][7]}", cam[0], ("camera", None)),
        (f"jpeg variants shadow, the .ibl sun in slot 1, tile {shadow[1][7]}", shadow[1],
         ("shadow", 1)),
    ):
        k = check_k1(torch, cr, args, label, card)
        entries.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43",
                            launches=per_key[key], library_ms=None, **k))
    shutil.rmtree(fx_dir, ignore_errors=True)
    return entries, ms


def main() -> None:
    global T_START
    T_START = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "stillleben_tpu_torch")):
        fail("the stillleben_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    phase("device", f"{name}; count {torch.cuda.device_count()}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {card}")
    card = f"{name}; {card}"

    # 2. build: every source at once
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.ops import fine_raster as fr
    from stillleben_tpu_torch.ops import nvcc, smoke
    from stillleben_tpu_torch.render import frame as frame_mod
    from stillleben_tpu_torch.render import rasterize_tiled as rt

    t0 = time.perf_counter()
    built = nvcc.build_all()
    phase("build", f"{', '.join(sorted(built))} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for source, (lib_path, log) in built.items():
        print(f"--- {source} -> {os.path.relpath(lib_path, ROOT)}\n{log.strip()}", flush=True)

    kernels = []  # the JSON line's entries

    # 3. toolchain: K4, beside an empty kernel's launch
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(SEED)).to(dev)
    smoke.double.launches = 0
    o = smoke.double(x)
    torch.cuda.synchronize()
    k4_launches = smoke.double.launches
    exact = torch.equal(o, smoke.double_reference(x))
    err = float((o - smoke.double_reference(x)).abs().max())
    ms = cuda_time(torch, lambda: smoke.double(x), 100)
    plain_ms = cuda_time(torch, lambda: smoke.double_reference(x), 100)
    library_ms = cuda_time(torch, lambda: torch.mul(x, 2.0), 100)
    launch_ms = cuda_time(torch, lambda: smoke.empty_launch(dev), 100)
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel())
    phase("toolchain", f"o = 2x on (8, 128) f32: exact {exact}; kernel {ms:.4f} ms, plain "
                       f"{plain_ms:.4f} ms, torch.mul {library_ms:.4f} ms, an empty kernel's "
                       f"launch {launch_ms:.4f} ms (the bound of a kernel this small), bytes "
                       f"bound {b_ms:.6f} ms ({b_by}) ({card})")
    if not exact or k4_launches != 1:
        fail(f"the toolchain kernel is wrong (exact {exact}, launches {k4_launches})")
    kernels.append(dict(
        name="smoke[o = 2x, (8, 128)]", route="cuda", source="stillleben_tpu_torch/csrc/smoke.cu",
        replaces="tools/tpu_smoke.py:73", launches=k4_launches, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        launch_bound_ms=launch_ms,
    ))

    # 4. the scenes, the light map's precompute, and one settle of B scenes
    from stillleben_tpu_torch.parallel.batch import (
        generate_batch, render_with_poses, settle_scene, template_from_scene,
    )
    from stillleben_tpu_torch.physics.types import default_config
    from stillleben_tpu_torch.render.frame import FrameConfig, render_frame_core
    from stillleben_tpu_torch.render.light_map import LightMap

    from stillleben_tpu_torch.assets.procedural import sky_equirect

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    light_map = LightMap.from_equirect(sky_equirect(), lights=[SUN_LIGHT])  # on the card
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    if light_map.data.cubemap.device.type != "cuda":
        fail(f"LightMap.from_equirect put the light map on {light_map.data.cubemap.device}")
    phase("light map", f"precompute of the 64x128 sky (512^2 cube, 32^2 irradiance of 64 x 16 "
                       f"samples + SH, 5 prefiltered levels of 256 samples): {lm_s:.3f} s, once "
                       f"per template ({card})")

    t0 = time.perf_counter()
    scene = bench_scene()
    tpl = template_from_scene(scene)  # on the card by default
    full = bench_full_scene(light_map)
    ftpl = template_from_scene(full)
    atlas, fatlas = tpl.render_atlas, ftpl.render_atlas
    if atlas.faces.device.type != "cuda" or ftpl.light_map.cubemap.device.type != "cuda":
        fail(f"template_from_scene put the template on {atlas.faces.device}")
    phase("scene", f"bench-slice: {len(scene.objects)} objects, {atlas.faces.shape[0]} faces, "
                   f"{atlas.shadow_faces.shape[0]} shadow-proxy faces; bench-full: "
                   f"{fatlas.num_objects} slots (the plane last), {fatlas.faces.shape[0]} faces, "
                   f"{fatlas.shadow_faces.shape[0]} shadow-proxy faces, "
                   f"{int((fatlas.mat_base_tex >= 0).sum())} textured materials, tex_combo "
                   f"{tuple(fatlas.tex_combo.shape)}; {tpl.hull_atlas.verts.shape[0]} hulls; "
                   f"built in {time.perf_counter() - t0:.1f} s")
    if fatlas.num_objects != len(full.objects) + 1 or ftpl.base_inputs.obj_instance.shape[0] != 11:
        fail("bench-full: the background plane's slot is missing")
    cfg = FrameConfig(width=WIDTH, height=HEIGHT, shading="pbr", max_lights=1,
                      shadow_mode="vsm", shadow_size=SHADOW_SIZE, ssao=False,
                      sample_textures=False, sample_stickers=False)
    ccfg = cfg._replace(raster="classic", tile_capacity=256, big_capacity=64, fine_chunk=128,
                        pixel_stage=None, fine_tiles_per_cell=1)
    fcfg = FrameConfig(width=WIDTH, height=HEIGHT, shading="pbr", ssao=True, ssao_mode="fast",
                       max_lights=1, shadow_size=SHADOW_SIZE, shadow_mode="vsm",
                       texture_filter="trilinear", sample_textures=True, sample_stickers=False,
                       tile_capacity=128, fine_chunk=128)
    fccfg = fcfg._replace(raster="classic")
    solver_cfg = default_config()
    gen = torch.Generator().manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses8, cams8, lights8 = settle_scene(gen, BATCH, ftpl, solver_cfg)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    phase("settle", f"settle_scene of {BATCH} scenes: {settle_s:.3f} s ({card})")

    def render(c, b=0, t=None):
        return render_with_poses(tpl if t is None else t, poses8[b], cams8[b], c, lights8[b])

    # 5. kernels against their plain versions, on one render's real inputs,
    # of each configuration
    k1, k2, k3 = {}, {}, {}
    uses = {16: "camera", 32: "shadow", 64: "shadow"}
    captured = {}
    for conf, t, c_cells, c_classic in (("bench-slice", tpl, cfg, ccfg),
                                        ("bench-full", ftpl, fcfg, fccfg)):
        k1_in = capture(rt, "cell_raster", lambda a, kw: a[7], lambda: render(c_cells, 0, t))
        if set(k1_in) != {16, 32}:
            fail(f"expected a tile-16 camera and a tile-32 shadow cell pass, got {sorted(k1_in)}")
        k2_in = capture(rt, "fine_raster", lambda a, kw: kw["tile"], lambda: render(c_classic, 0, t))
        if set(k2_in) != {16, 64}:
            fail(f"expected a tile-16 camera and a tile-64 shadow fine pass, got {sorted(k2_in)}")
        captured[conf] = (k1_in, k2_in)
        for tile, (args, _) in sorted(k1_in.items()):
            k1[(conf, tile)] = check_k1(torch, cr, args, f"{conf} {uses[tile]}", card)
        for tile, (args, kw) in sorted(k2_in.items()):
            label = f"{conf} {uses[tile]}"
            k2[(conf, tile)], out_k, out_p = check_k2(torch, fr, args, kw, label, card)
            for tpg in (4, 8):
                k3[(conf, tile, tpg)] = check_k3(torch, fr, args, kw, label, card,
                                                 k2[(conf, tile)], out_k, out_p, tpg)
            del out_k, out_p

    # the torch stages of the earlier design that the kernels now do: the
    # row gather G = LT[ids] and the per-cell floor before K1 and the
    # cells -> tiles merge after it; the gather and transpose before K2
    k1_in, k2_in = captured["bench-slice"]
    for tile, (args, _) in sorted(k1_in.items()):
        LT, ids, cell_tile, _, near, far, tw, _, n_tiles = args
        n, C = ids.shape

        def gather():
            return LT[torch.clamp(ids, min=0).long().reshape(-1)].reshape(n, C, cr.FIELDS)

        G = gather()
        mdc = torch.zeros((n, tile * tile), device=dev)
        w_c, t_c = cr.cell_raster_reference(G, ids, cell_tile, mdc, near, far, tw, tile, n_tiles)
        g_ms = cuda_time(torch, gather, 50)
        z_ms = cuda_time(torch, lambda: torch.zeros((n, tile * tile), device=dev), 50)
        m_ms = cuda_time(torch, lambda: cr.merge_cells(w_c, t_c, cell_tile, n_tiles), 50)
        phase("stages", f"cells {uses[tile]}, tile {tile}: gather G = LT[ids] {g_ms:.4f} ms, "
                        f"per-cell floor zeros {z_ms:.4f} ms, merge_cells {m_ms:.4f} ms "
                        f"({card})")
        del G, mdc, w_c, t_c
    for tile, (args, kw) in sorted(k2_in.items()):
        LT, ids = args[:2]
        n_tiles, n_chunks, C = ids.shape

        def gather_t():
            g = LT[torch.clamp(ids, min=0).reshape(-1).long()]
            return g.reshape(n_tiles, n_chunks, C, fr.FIELDS).transpose(2, 3).contiguous()

        f_ms = cuda_time(torch, gather_t, 50)
        phase("stages", f"classic {uses[tile]}, tile {tile}: gather + transpose {f_ms:.4f} ms "
                        f"({card})")
    del captured, k1_in, k2_in

    # 6. the main path: bench-full through the cell raster, first and warm
    gen = torch.Generator().manual_seed(SEED)
    cr.reset_launch_counts()
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, plain_calls = count_calls(
        cr, ("cell_raster_plain", "merge_cells", "cell_raster_reference"),
        lambda: generate_batch(gen, BATCH, ftpl, fcfg, solver_cfg))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    full_k1_launches = dict(cr.cell_raster.launches_by_tile)
    phase("main", f"bench-full, cells: generate_batch B={BATCH} {WIDTH}x{HEIGHT}: first call "
                  f"{cold_s:.3f} s; K1 launches by tile {full_k1_launches}, K2/K3 launches "
                  f"{fr.fine_raster.launches}; calls of K1's plain pieces {plain_calls}")
    phase("main", f"bench-full, cells: content: {check_frames(torch, frames, 'bench-full cells')}; "
                  f"{check_full_frames(torch, frames, 'bench-full cells')}")
    if full_k1_launches.get(16, 0) <= 0 or full_k1_launches.get(32, 0) <= 0:
        fail(f"the cells path did not launch K1 for both passes: {full_k1_launches}")
    if any(plain_calls.values()):
        fail(f"the cells path on the card called K1's plain pieces: {plain_calls}")
    phase6 = type(frames)(*(x.cpu() for x in frames))  # phase 17 holds its shards to these
    del frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_batch(gen, BATCH, ftpl, fcfg, solver_cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    phase("main", f"bench-full, cells: warm call {warm_s:.3f} s: {BATCH / warm_s:.4f} scenes/s "
                  f"({card})")

    # 7. bench-slice, the untextured configuration of the earlier slices:
    # one warm call through each raster
    results = {}
    for label, c, mod, attrs in (
        ("cells", cfg, cr, ("cell_raster_plain", "merge_cells", "cell_raster_reference")),
        ("classic", ccfg, fr, ("fine_raster_plain", "fine_raster_reference")),
    ):
        cr.reset_launch_counts()
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames, plain_calls = count_calls(
            mod, attrs, lambda: generate_batch(gen, SLICE_BATCH, tpl, c, solver_cfg, SLICE_ITERATIONS))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        results[label] = (dict(cr.cell_raster.launches_by_tile),
                          dict(fr.fine_raster.launches_by_shape))
        phase("main", f"bench-slice, {label}: generate_batch B={SLICE_BATCH} {WIDTH}x{HEIGHT}, "
                      f"{SLICE_ITERATIONS} settle frames: {s:.3f} s, "
                      f"{SLICE_BATCH / s:.4f} scenes/s ({card}); K1 launches by tile "
                      f"{results[label][0]}, K2 launches by (tile, tiles per block) "
                      f"{results[label][1]}; calls of the plain pieces {plain_calls}")
        phase("main", f"bench-slice, {label}: content: {check_frames(torch, frames, label)}")
        if any(plain_calls.values()):
            fail(f"the {label} path on the card called plain pieces: {plain_calls}")
        del frames
    k1_launches, k2_launches = results["cells"][0], results["classic"][1]
    if k1_launches.get(16, 0) <= 0 or k1_launches.get(32, 0) <= 0 or results["cells"][1]:
        fail(f"the cells path did not launch K1 alone for both passes: {results['cells']}")
    if (k2_launches.get((16, 1), 0) <= 0 or k2_launches.get((64, 1), 0) <= 0
            or results["classic"][0]):
        fail(f"the classic path did not launch K2 alone for both passes: {results['classic']}")

    # 8. where the time goes: the settle above, then 8 renders per raster
    # and configuration, on the same settled poses
    def render_all(c, t=None):
        render(c, 0, t)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [render(c, b, t) for b in range(BATCH)]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / BATCH * 1e3

    def raster_agreement(conf, cells_frames, classic_frames, c, t):
        # The classic pixel stage keeps the first max(4096, F/16) triangles
        # of its 2-4-px class (rasterize_tiled.py:780 in the JAX package)
        # and drops the rest: a dropped triangle in view leaves a hole, a
        # pixel the cell raster covers and the classic one does not. Every
        # other disagreement must stay under 3% of the image.
        for b, (fc, fk) in enumerate(zip(cells_frames, classic_frames)):
            stage = capture(rt, "_run_pixel_stages", lambda a, kw: 0, lambda: render(c, b, t))
            n_tiny4 = cap4 = 0  # no pixel stage under 20,000 faces
            if stage:
                Lf, _, tiny, span_x, span_y = stage[0][0][:5]
                n_tiny4 = int((tiny & ~((span_x <= 2) & (span_y <= 2))).sum())
                cap4 = min(Lf.shape[0], max(4096, Lf.shape[0] // 16))
            differ = fc.instance_index != fk.instance_index
            # a hole shows what lies behind: another object, the plane or nothing
            holes = int((differ & fc.valid & (~fk.valid | (fk.depth > fc.depth))).sum())
            other = int(differ.sum()) - holes
            agree = 1.0 - int(differ.sum()) / differ.numel()
            phase("breakdown", f"{conf} scene {b}: classic vs cells instance agreement "
                               f"{agree:.6f}; classic holes {holes} px, other disagreement "
                               f"{other} px; pixel stage 2-4-px class {n_tiny4} triangles, "
                               f"{max(0, n_tiny4 - cap4)} beyond its {cap4} slots")
            if other > 0.03 * differ.numel() or (holes > 0.03 * differ.numel() and n_tiny4 <= cap4):
                fail(f"{conf} scene {b}: the classic raster disagrees with the cell raster")

    cells_frames, cells_ms = render_all(cfg)
    classic_frames, classic_ms = render_all(ccfg)
    cr.reset_launch_counts()
    fr.reset_launch_counts()
    full_cells, full_cells_ms = render_all(fcfg, ftpl)
    full_classic, plain_calls = count_calls(
        fr, ("fine_raster_plain", "fine_raster_reference"), lambda: render_all(fccfg, ftpl))
    full_classic, full_classic_ms = full_classic
    full_k2_launches = dict(fr.fine_raster.launches_by_shape)
    if any(plain_calls.values()) or full_k2_launches.get((16, 1), 0) <= 0:
        fail(f"bench-full classic: plain calls {plain_calls}, K2 launches {full_k2_launches}")
    phase("breakdown", f"settle of {BATCH} scenes {settle_s:.3f} s; render per scene: bench-slice "
                       f"{cells_ms:.2f} ms (cells), {classic_ms:.2f} ms (classic); bench-full "
                       f"{full_cells_ms:.2f} ms (cells), {full_classic_ms:.2f} ms (classic; K2 "
                       f"launches {full_k2_launches}) ({card})")
    for b, f in enumerate(full_classic):
        stacked = type(f)(*(x[None] for x in f))
        check_frames(torch, stacked, f"bench-full classic scene {b}")
        check_full_frames(torch, stacked, f"bench-full classic scene {b}")
    raster_agreement("bench-slice", cells_frames, classic_frames, ccfg, tpl)
    raster_agreement("bench-full", full_cells, full_classic, fccfg, ftpl)
    # bench-full against bench-slice on the same poses, and one of
    # texture, image-based light and SSAO off at a time (scene 0)
    ref = full_cells[0].hdr[..., :3]

    def mean_abs(f):
        return float((f.hdr[..., :3] - ref).abs().mean())

    diffs = {
        "bench-slice": mean_abs(cells_frames[0]),
        "textures off": mean_abs(render(fcfg._replace(sample_textures=False), 0, ftpl)),
        "light map off": mean_abs(render(fcfg, 0, ftpl._replace(light_map=None))),
        "SSAO off": mean_abs(render(fcfg._replace(ssao=False), 0, ftpl)),
    }
    rgb_differs = float((full_cells[0].rgb != cells_frames[0].rgb).any(-1).float().mean())
    phase("breakdown", f"bench-full scene 0, mean |hdr rgb difference| to the same poses with: "
                       f"{ {k: round(v, 6) for k, v in diffs.items()} }; rgb differs from "
                       f"bench-slice's on {rgb_differs:.4f} of the pixels")
    if min(diffs.values()) <= 0 or rgb_differs <= 0:
        fail(f"a stage of bench-full changes nothing: {diffs}")
    k3_launches = {}
    for conf, c, t, k2_frames in (("bench-slice", ccfg, tpl, classic_frames),
                                  ("bench-full", fccfg, ftpl, full_classic)):
        for tpg in (4, 8):
            cr.reset_launch_counts()
            fr.reset_launch_counts()
            tpg_frames, tpg_ms = render_all(c._replace(fine_tiles_per_cell=tpg), t)
            for (tile, n), launched in fr.fine_raster.launches_by_shape.items():
                k3_launches[(conf, tile, n)] = launched
            same = all(
                torch.equal(getattr(a, f), getattr(b, f))
                for a, b in zip(tpg_frames, k2_frames) for f in a._fields
            )
            phase("breakdown", f"{conf} classic with {tpg} tiles per block (K3): {tpg_ms:.2f} ms "
                               f"per scene; launches {dict(fr.fine_raster.launches_by_shape)}; "
                               f"frames bitwise equal to K2's: {same}")
            if not same:
                fail(f"{conf}: K3 ({tpg} tiles per block) frames differ from K2's")
    del cells_frames, full_cells, full_classic, classic_frames, tpg_frames, k2_frames
    for conf, c, t in (("bench-full cells", fcfg, ftpl), ("bench-full classic", fccfg, ftpl)):
        times = stage_times(torch, lambda: render(c, 0, t))
        total = sum(ms for _, ms in times)
        phase("stages", f"{conf}, one render, device ms by stage (CUDA events at the stage "
                        f"marks; the host issues the ops, so a stage is at least its launches): "
                        + ", ".join(f"{n} {ms:.3f}" for n, ms in times)
                        + f"; total {total:.3f} ms ({card})")

    # 9. the rest of the slice, one scene at 640x480: stickers, the other
    # texture filters, the reference SSAO, the alpha peel, a background image
    xs = extras_scene(light_map)
    xtpl = template_from_scene(xs)
    xp, xc, xl = settle_scene(torch.Generator().manual_seed(SEED + 3), 1, xtpl, solver_cfg, 25)
    xcfg = fcfg._replace(sample_stickers=True)

    def xrender(c, t=xtpl):
        return render_with_poses(t, xp[0], xc[0], c, xl[0])

    base = xrender(xcfg)
    check_frames(torch, type(base)(*(x[None] for x in base)), "extras")
    no_sticker = xrender(xcfg._replace(sample_stickers=False))
    in_range = sticker_footprint(torch, xs, base)
    changed = (base.hdr != no_sticker.hdr).any(-1)
    phase("extras", f"stickers on 2 objects: {int(in_range.sum())} px inside a sticker's range, "
                    f"{int(changed.sum())} px changed by the stickers, "
                    f"{int((changed & ~in_range).sum())} of them outside")
    if not changed.any() or (changed & ~in_range).any():
        fail("the stickers changed nothing, or pixels outside their range")
    for what, c in (("aniso", xcfg._replace(texture_filter="aniso")),
                    ("bilinear", xcfg._replace(texture_filter="bilinear")),
                    ("ssao reference", xcfg._replace(ssao_mode="reference"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = xrender(c)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_frames(torch, type(f)(*(x[None] for x in f)), what)
        d = float((f.hdr[..., :3] - base.hdr[..., :3]).abs().mean())
        phase("extras", f"{what}: finite; mean |hdr rgb difference| to trilinear + fast SSAO "
                        f"{d:.6f}; {ms:.1f} ms, first call ({card})")
        if d <= 0:
            fail(f"{what} changed nothing")
    # the peel: K1's second camera pass takes the depth-peel floor
    calls = []
    gbufs = []
    orig_cell, orig_rast = rt.cell_raster, frame_mod.rasterize_tiled

    def rec_cell(*a):
        calls.append(tuple(t.clone() if hasattr(t, "clone") else t for t in a))
        return orig_cell(*a)

    def rec_rast(*a, **kw):
        gbufs.append(orig_rast(*a, **kw))
        return gbufs[-1]

    cr.reset_launch_counts()
    rt.cell_raster, frame_mod.rasterize_tiled = rec_cell, rec_rast
    try:
        peeled = xrender(xcfg._replace(alpha_peel=True))
    finally:
        rt.cell_raster, frame_mod.rasterize_tiled = orig_cell, orig_rast
    peel_launches = cr.cell_raster.launches_by_tile.get(16, 0)
    with_md = [a for a in calls if a[7] == 16 and a[3] is not None]
    if len(gbufs) != 2 or len(with_md) != 1 or peel_launches != 2:
        fail(f"the peel render made {len(gbufs)} camera passes, {len(with_md)} with md_tiles")
    k1[("peel", 16)] = check_k1(torch, cr, with_md[0], "extras peel pass (camera)", card)
    check_frames(torch, type(peeled)(*(x[None] for x in peeled)), "peel")
    discarded = (gbufs[0].tri_id >= 0) & ~base.valid
    shown = discarded & peeled.valid
    deeper = peeled.depth[shown] > gbufs[0].depth[shown]
    phase("extras", f"alpha peel on the cutout texture: {int(discarded.sum())} px discarded by "
                    f"the first pass, {int(shown.sum())} show a surface after the peel, "
                    f"{int(deeper.sum())} of them deeper than the first pass's winner")
    if discarded.sum() < 10 or not deeper.all() or shown.sum() == 0:
        fail("the alpha peel did not show the surfaces behind the cutout")
    if not torch.equal(peeled.valid | discarded, base.valid | discarded):
        fail("the alpha peel changed pixels the first pass did not discard")
    # a background image behind the objects, the plane hidden
    vis = xtpl.base_inputs.obj_visible.clone()
    vis[-1] = False
    inputs = xtpl.base_inputs._replace(obj_visible=vis, cam_pose=xc[0])
    otw = inputs.obj_to_world.clone()
    otw[: xp.shape[1]] = xp[0]
    inputs = inputs._replace(obj_to_world=otw)
    image = torch.rand((HEIGHT, WIDTH, 4), generator=torch.Generator().manual_seed(SEED)).to(dev)
    f = render_frame_core(xtpl.render_atlas, inputs, xcfg, background_image=image,
                          light_map=xtpl.light_map)
    back = ~f.valid
    ok = torch.equal(f.hdr[back][:, :3], image[back][:, :3]) and bool((f.hdr[back][:, 3] == 1).all())
    phase("extras", f"background image: {int(back.sum())} background px show the image: {ok}")
    if back.sum() == 0 or not ok or not torch.isfinite(f.hdr).all():
        fail("the background image does not show behind the objects")
    del base, no_sticker, peeled, f, gbufs, calls

    # 10. the rungs of bench.py on the bench-full template: tuned
    # (TUNED.json) and reference quality (BENCH_REFMODE=1)
    rung = run_rungs(torch, cr, fr, rt, ftpl, fcfg, light_map, render, card)

    # 11. the card against the port's own CPU run: the small full scene at
    # 160x120 in the bench-full, tuned and refmode frame configurations, the
    # device passed explicitly to both
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_gpu import compare_full_frames, full_config

    small_lm = LightMap.from_equirect(sky_equirect(), lights=[SUN_LIGHT], device="cpu")
    small_cpu = template_from_scene(small_full_scene(small_lm), "cpu")
    small_gpu = template_from_scene(small_full_scene(small_lm), "cuda")
    sp, sc, sl = settle_scene(torch.Generator().manual_seed(SEED + 4), 1, small_cpu, solver_cfg, 10)
    small_state = (sp[0], sc[0], sl[0])
    for config in (None, "tuned", "refmode"):
        summary = compare_full_frames(small_cpu, small_gpu, *small_state, (160, 120),
                                      full_config((160, 120), config))
        phase("card vs cpu", f"small full scene 160x120, {config or 'bench-full'} configuration, "
                             f"cuda against cpu: {summary} ({card})")

    # 12. both rasters against the brute-force oracle on a small input
    small = small_scene()
    stpl = template_from_scene(small)
    scfg = cfg._replace(width=160, height=120, shadow_size=512)
    sp, sc, sl = settle_scene(torch.Generator().manual_seed(SEED + 2), 1, stpl, solver_cfg, 20)
    fb = render_with_poses(stpl, sp[0], sc[0], scfg._replace(tiled=False), sl[0])
    n_obj = int(fb.valid.sum())
    for raster, need in (("cells", 0.999), ("classic", 0.97)):
        fk = render_with_poses(stpl, sp[0], sc[0], scfg._replace(raster=raster), sl[0])
        same = float((fk.instance_index == fb.instance_index).float().mean())
        both = fk.valid & fb.valid
        depth_err = float((fk.depth - fb.depth)[both].abs().max()) if both.any() else 0.0
        phase("reference", f"small scene 160x120, {raster} raster vs brute-force oracle: "
                           f"instance map agrees on {same:.6f} of pixels ({n_obj} object pixels), "
                           f"max depth difference {depth_err:.3g}")
        if same < need or n_obj == 0:
            fail(f"the {raster} raster disagrees with the brute-force oracle")

    # 13. the public host API: Scene -> simulate_tabletop_scene ->
    # RenderPass().render, a depth-peel pass and supersample=2, two seeds
    api_entries, api_scene, api_settle_s, make_api_scene = run_api(torch, cr, rt, light_map, card)
    kernels.extend(api_entries)

    # 16. the rest of the public table on phase 13's scene of seed 0, before
    # phase 14 moves that scene into the camera frame: the viewer and its
    # web front-end, sanitize, profiling, extension, ManipulationSim with
    # telemetry, JobQueue
    t0 = time.perf_counter()
    kernels.extend(run_public_table(torch, cr, rt, api_scene, api_settle_s, make_api_scene, card))
    phase("public table", f"phase 16 in {time.perf_counter() - t0:.1f} s")

    # 14. render-and-compare pose refinement: the trainer on phase 4's
    # settled bench-full scene 0, the card against the CPU on phase 11's
    # small full scene, the reference route on phase 13's API scene
    from test_torch_gpu import compare_gradients

    refine_k1, refine = run_refine_trainer(torch, cr, rt, ftpl, fcfg, poses8[0], cams8[0],
                                           lights8[0], card)
    summary = compare_gradients(small_cpu, small_gpu, *small_state, (160, 120))
    phase("refine", f"card vs cpu: small full scene 160x120, bench-full configuration, "
                    f"d loss / d delta at delta {REFINE_DELTA}: {summary} (tolerance 2e-2 of each "
                    f"object's largest component) ({card})")
    peel_args, peel_launches = run_refine_reference(torch, cr, rt, api_scene, card)
    for label, args, n in (
        ("refine trainer camera, tile 16", refine_k1[16][0], refine["launches"].get(16, 0)),
        ("refine trainer shadow, tile 32", refine_k1[32][0], refine["launches"].get(32, 0)),
        ("refine soft_forward peel pass, camera, tile 16, md_tiles given", peel_args,
         peel_launches),
    ):
        k = check_k1(torch, cr, args, label, card)
        kernels.append(dict(name=f"cell_raster[{label}]", route="cuda",
                            source="stillleben_tpu_torch/csrc/cell_raster.cu",
                            replaces="stillleben_tpu/ops/cell_raster.py:43", launches=n,
                            library_ms=None, **k))

    # 15. the reference's asset and light-map loading path: every mesh
    # format and primitive://, the native cooker, LightMap(.ibl), one
    # settled and rendered scene of loaded meshes, ImageSaver / ImageLoader
    loader_k1, loader_secs = run_loaders(torch, cr, rt, card)
    kernels.extend(loader_k1)
    phase("loaders", "seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in loader_secs.items()))

    # 17. scale-out: generate_batch_sharded on a one-card mesh against phase
    # 6, two gloo processes on the card, the atlas modes, the scan rule
    kernels.extend(run_scale_out(torch, cr, fr, rt, full, ftpl, fcfg, fccfg, solver_cfg, phase6,
                                 full_k1_launches, cold_s, (poses8[0], cams8[0], lights8[0]),
                                 k1, k2, card))
    del phase6

    # 18. the image formats: the codec's build, Pillow's digests, the
    # decoded-texture scene through K1, the codec's times, the ycb example
    t0 = time.perf_counter()
    image_k1, _, image_settled = run_image_formats(torch, cr, rt, card)
    kernels.extend(image_k1)
    phase("images", f"phase 18 in {time.perf_counter() - t0:.1f} s")

    # 19. WebP and the tools: the decoder's build and digests, phase 18's
    # scene from WebP files at its settled poses, the decode's times, and
    # settle_fidelity, display_mesh, viewer_demo and align_mesh on the card
    t0 = time.perf_counter()
    webp_k1, _, webp_render = run_webp_tools(torch, cr, rt, card, image_settled)
    kernels.extend(webp_k1)
    phase("webp+tools", f"phase 19 in {time.perf_counter() - t0:.1f} s")

    # 20. WebP encoding: the encoder's build, the committed q80 fixtures
    # from their sources, phase 19's render through ImageSaver, the times
    t0 = time.perf_counter()
    run_webp_encode(card, webp_render)
    phase("webp-enc", f"phase 20 in {time.perf_counter() - t0:.1f} s")

    # 21. GIF and Netpbm encoding: the encoder's build, the committed encode
    # fixtures from their sources, phase 19's render as GIF and its depth as
    # a 16-bit PGM through ImageSaver, the times
    t0 = time.perf_counter()
    run_gif_netpbm(card, webp_render)
    phase("gif+pnm", f"phase 21 in {time.perf_counter() - t0:.1f} s")

    # 22. QOI, SGI, PCX/DCX, IM and DDS: the core's build, the committed
    # fixtures from their sources and to Pillow's digests, phase 19's render
    # and depth through ImageSaver, the times
    t0 = time.perf_counter()
    run_plain_formats(card, webp_render)
    del webp_render
    phase("plain", f"phase 22 in {time.perf_counter() - t0:.1f} s")

    # 23. the JPEG variants: the committed arithmetic, lossless, CMYK/YCCK,
    # block-smoothed and refused files to their digests, the 640x480
    # decode's times, and phase 18's scene from variant files through K1
    t0 = time.perf_counter()
    jpeg_k1, _ = run_jpeg_variants(torch, cr, rt, card, image_settled)
    kernels.extend(jpeg_k1)
    phase("jpeg-variants", f"phase 23 in {time.perf_counter() - t0:.1f} s")
    phase("total", f"the smoke's wall time so far: {time.perf_counter() - T_START:.1f} s")

    # the kernels' line: K1 and K2 at each configuration's shapes; launches
    # are those of that configuration's main path (bench-full classic: its
    # 8 renders and their warm-up on the settled poses)
    launches = {"bench-slice": (k1_launches, k2_launches),
                "bench-full": (full_k1_launches, full_k2_launches)}
    for conf in ("bench-slice", "bench-full"):
        for tile in (16, 32):
            kernels.append(dict(
                name=f"cell_raster[{conf} {uses[tile]}, tile {tile}]", route="cuda",
                source="stillleben_tpu_torch/csrc/cell_raster.cu",
                replaces="stillleben_tpu/ops/cell_raster.py:43", launches=launches[conf][0][tile],
                library_ms=None, **k1[(conf, tile)],
            ))
        for tile in (16, 64):
            kernels.append(dict(
                name=f"fine_raster[{conf} {uses[tile]}, tile {tile}]", route="cuda",
                source="stillleben_tpu_torch/csrc/fine_raster.cu",
                replaces="stillleben_tpu/ops/fine_raster.py:98",
                launches=launches[conf][1][(tile, 1)], library_ms=None, **k2[(conf, tile)],
            ))
    kernels.append(dict(
        name="cell_raster[extras peel pass, camera, tile 16, md_tiles given]", route="cuda",
        source="stillleben_tpu_torch/csrc/cell_raster.cu",
        replaces="stillleben_tpu/ops/cell_raster.py:43", launches=len(with_md),
        library_ms=None, **k1[("peel", 16)],
    ))
    for (conf, tile, tpg), entry in sorted(k3.items()):
        kernels.append(dict(
            name=f"fine_raster_grouped[{conf} {uses[tile]}, tile {tile}, {tpg} tiles per block]",
            route="cuda", source="stillleben_tpu_torch/csrc/fine_raster.cu",
            replaces="stillleben_tpu/ops/fine_raster.py:130",
            launches=k3_launches.get((conf, tile, tpg), 0), library_ms=None, **entry,
        ))
    kernels.extend(rung["kernels"])
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel was not launched on its path: {[k['name'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0] if smi else "nvidia-smi gave nothing", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
