"""RenderPass / RenderPassResult: the user-facing render API.

Counterpart of ``stillleben_tpu/render/render_pass.py`` (reference
python/src/py_render_pass.cpp, src/render_pass.cpp):

    pass = RenderPass(shading='pbr')        # 'pbr' | 'phong' | 'flat'
    result = pass.render(scene, depth_peel=prev_result, predicate=fn)
    result.rgb()               # (H, W, 4) uint8
    result.class_index()       # (H, W) uint16
    result.instance_index()    # (H, W) uint16
    result.coordinates()       # (H, W, 3) f32 object coords (3000 = invalid)
    result.depth()             # (H, W) f32 camera-space z (3000 = invalid)
    result.coordDepth()        # (H, W, 4)
    result.normals()           # (H, W, 4) cam-space normal + dot(N, V)
    result.vertex_indices()    # (H, W, 3) int32 (1-based, 0 = background)
    result.barycentric_coeffs()# (H, W, 3) f32
    result.cam_coordinates()   # (H, W, 4)

The frame is rendered on the context's device (``context.init``) and the
accessors return tensors there. As in the reference, 'phong' and 'pbr' are
one shader (render_pass.cpp:54-65); 'flat' differs. Every z-buffer of the
frame (the camera pass, one shadow pass per active light slot, the peel's
second pass) is the cell raster, ``ops/cell_raster.py``: its CUDA kernel on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..context import context
from ..utils import sanitize
from .atlas import build_scene_atlas, has_cutout_materials, render_inputs_from_scene, resize_bilinear_u8
from .frame import FrameConfig, RenderedFrame, render_frame_core
from .light_map import LightMapData


class RenderPassResult:
    def __init__(self, frame: RenderedFrame):
        self._f = frame

    def rgb(self):
        return self._f.rgb

    def class_index(self):
        return self._f.class_index

    def instance_index(self):
        return self._f.instance_index

    def coordinates(self):
        return self._f.object_coordinates[..., :3]

    def depth(self):
        return self._f.object_coordinates[..., 3]

    def coordDepth(self):
        return self._f.object_coordinates

    def coord_depth(self):
        return self._f.object_coordinates

    def normals(self):
        return self._f.normals

    def vertex_indices(self):
        return self._f.vertex_indices

    def barycentric_coeffs(self):
        return self._f.barycentric_coeffs

    def cam_coordinates(self):
        return self._f.cam_coordinates

    @property
    def frame(self) -> RenderedFrame:
        return self._f


class RenderPass:
    def __init__(self, shading: str = "pbr", ssao: bool = True,
                 shadow_mode: str = "vsm", ssao_mode: str = "fast",
                 supersample: int = 1, texture_filter: str = "trilinear",
                 shadow_proxy_target: int = 8192, cull_closedness: float = 0.98):
        if shading not in ("pbr", "phong", "flat"):
            raise ValueError(f"unknown shading type {shading!r}")
        if shadow_mode not in ("vsm", "pcf"):
            raise ValueError(f"unknown shadow mode {shadow_mode!r}")
        if texture_filter not in ("trilinear", "bilinear", "aniso"):
            raise ValueError(f"unknown texture filter {texture_filter!r}")
        if supersample < 1:
            raise ValueError("supersample must be >= 1")
        self._shading = "flat" if shading == "flat" else "pbr"
        self.ssao_enabled = ssao
        self.ssao_mode = ssao_mode
        self.shadow_mode = shadow_mode
        self.texture_filter = texture_filter
        # anti-aliasing beyond the reference: render supersample^2 times the
        # pixels; rgb and hdr are box-filtered down, every ground-truth
        # buffer takes the centre sample (indices cannot average)
        self.supersample = int(supersample)
        # the atlas's two modes (build_scene_atlas; SL_SHADOW_PROXY and
        # SL_CULL_CLOSEDNESS in the JAX package)
        self.shadow_proxy_target = int(shadow_proxy_target)
        self.cull_closedness = float(cull_closedness)
        self._atlas = None  # cached on the scene's object-set stamp
        self._atlas_key = None

    def _get_atlas(self, scene, device):
        bg_plane = None
        if np.any(scene.background_plane_size):
            tex = scene.background_plane_texture
            bg_plane = {"size": scene.background_plane_size,
                        "texture": tex.pixels if tex is not None else None}
        key = (
            id(scene),
            tuple((id(o), o.mesh._dirty, o.mesh.class_index) for o in scene.objects),
            tuple(np.asarray(scene.background_plane_size).tolist()),
            id(scene.background_plane_texture),
            device,
            self.shadow_proxy_target,
            self.cull_closedness,
        )
        if self._atlas is None or self._atlas_key != key:
            self._atlas = build_scene_atlas(scene.objects, device, background_plane=bg_plane,
                                            shadow_proxy_target=self.shadow_proxy_target,
                                            cull_closedness=self.cull_closedness)
            self._atlas_key = key
        return self._atlas

    def render(
        self,
        scene,
        result=None,
        depth_peel: "RenderPassResult | None" = None,
        predicate=None,
    ) -> RenderPassResult:
        dev = context().device
        atlas = self._get_atlas(scene, dev)
        inputs = render_inputs_from_scene(scene, atlas, dev)

        if predicate is not None:
            vis = np.ones(atlas.num_objects, bool)
            for i, o in enumerate(scene.objects):
                vis[i] = bool(predicate(o))
            inputs = inputs._replace(obj_visible=torch.from_numpy(vis).to(dev))

        # the light map's analytic lights go into the free light slots, as
        # the reference's render pass lights and shadows them (render_pass.py:138-158)
        dirs, cols = scene.light_directions.copy(), scene.light_colors.copy()
        lm = scene.light_map
        light_map_data = None
        if lm is not None and lm.data is not None:
            light_map_data = LightMapData(*(None if x is None else x.to(dev) for x in lm.data))
            li = 0
            for d, c in zip(lm.light_directions, lm.light_colors):
                while li < len(dirs) and (np.any(dirs[li]) or np.any(cols[li])):
                    li += 1
                if li >= len(dirs):
                    break
                dirs[li] = d
                cols[li] = c
                li += 1
            inputs = inputs._replace(light_directions=torch.from_numpy(dirs).to(dev),
                                     light_colors=torch.from_numpy(cols).to(dev))

        has_tex = any(bool((t >= 0).any()) for t in (
            atlas.mat_base_tex, atlas.mat_mr_tex, atlas.mat_normal_tex, atlas.mat_emissive_tex))
        has_sticker = bool((atlas.obj_sticker_tex >= 0).any())
        ss = self.supersample
        W, H = scene.viewport[0] * ss, scene.viewport[1] * ss
        # the classic raster's tile lists grow with the triangle density:
        # dense scanned meshes put several triangles on each pixel of a tile
        n_tiles = max((W // 16) * (H // 16), 1)
        density = int(atlas.faces.shape[0]) * 8 // n_tiles
        tile_capacity = int(min(2048, max(256, 1 << (max(density, 1) - 1).bit_length())))
        # one shadow pass per light slot up to the last active one (after the
        # merge): a 1-light scene renders 1 shadow pass, not 3
        active = [i for i in range(dirs.shape[0]) if np.any(dirs[i]) and np.any(cols[i])]
        max_lights = (max(active) + 1) if active else 1

        cfg = FrameConfig(
            width=W,
            height=H,
            shading=self._shading,
            ssao=self.ssao_enabled,
            ssao_mode=self.ssao_mode,
            tile_capacity=tile_capacity,
            sample_textures=has_tex,
            sample_stickers=has_sticker,
            shadow_mode=self.shadow_mode,
            texture_filter=self.texture_filter,
            alpha_peel=has_cutout_materials(atlas),
            max_lights=max_lights,
            # the JAX package's automatic size: the reference's 2048^2 on
            # an accelerator, 512^2 on a CPU host (frame.py:36-37, shadow.py:212)
            shadow_size=2048 if dev.type != "cpu" else 512,
        )

        bg_image = None
        if scene.background_image is not None:
            tex = scene.background_image
            pix = tex.linear_f32()
            if pix.shape[:2] != (H, W):
                pix = resize_bilinear_u8(tex.pixels, (W, H)).astype(np.float32) / 255.0
                pix[..., :3] = pix[..., :3] ** 2.2
            bg_image = torch.from_numpy(pix).to(dev)

        peel = None
        if depth_peel is not None:
            # background pixels carry 3000 = invalid: no floor there
            peel = depth_peel.frame.object_coordinates[..., 3].to(dev)
            peel = torch.where(peel >= 2999.0, 0.0, peel)
            if ss > 1:  # the floor lives at the viewport's size
                peel = peel.repeat_interleave(ss, dim=0).repeat_interleave(ss, dim=1)

        frame = render_frame_core(atlas, inputs, cfg, background_image=bg_image,
                                  light_map=light_map_data, depth_peel_depth=peel)
        if ss > 1:
            frame = _downsample_frame(frame, ss)
        if sanitize.enabled():  # SL_SANITIZE=1: NaN/Inf audit of every buffer
            sanitize.check_finite(frame, "RenderPass output")
        return RenderPassResult(frame)


def _downsample_frame(frame: RenderedFrame, ss: int) -> RenderedFrame:
    """A supersampled frame at the viewport's size: rgb and hdr box-filtered
    (the anti-aliasing), every ground-truth buffer centre-sampled."""

    def down(name, a):
        H, W = a.shape[0] // ss, a.shape[1] // ss
        if name in ("rgb", "hdr"):
            x = a.to(torch.float32).reshape((H, ss, W, ss) + tuple(a.shape[2:])).mean(dim=(1, 3))
            if a.dtype == torch.uint8:
                return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
            return x.to(a.dtype)
        return a[ss // 2 :: ss, ss // 2 :: ss]

    return RenderedFrame(**{k: down(k, v) for k, v in frame._asdict().items()})
