"""Whole-frame render: geometry -> shadow maps -> raster -> shade (with the
alpha-peel rounds) -> SSAO -> background -> tone map.

Counterpart of ``stillleben_tpu/render/frame.py::render_frame_core``
(:74-199) and of its caller ``render_frame`` (:212-230). ``FrameConfig`` keeps the JAX field names and defaults; ``check()``
rejects values it does not know, so a config never silently means something
else. With ``shading="flat"`` or ``shadow_mode="off"`` there are no shadow
maps; ``"flat"`` also skips SSAO and clips the colour instead of tone
mapping it (:88-93, :152, :180-183). Fields of the JAX config that only
choose a TPU layout or precision (``use_pallas``, ``shading_dtype``) have no
counterpart. Where the JAX package reads an environment variable, the port
has a field with the same default: ``raster`` (``SL_RASTER``),
``fine_tiles_per_cell`` (``SL_FINE_TPG``), ``backface_cull``
(``SL_BACKFACE_CULL``), ``shadow_cull`` (``SL_SHADOW_CULL``), ``vsm_taps``
(``SL_VSM_TAPS``), ``ibl_prefilter`` (``SL_IBL_PREFILTER``), ``ibl_sh``
(``SL_IBL_SH``). JAX's ``use_pallas=False`` is ``raster="classic"`` with
``classic_fine="scan"``: the classic raster's XLA fine stage, which breaks
an equal-depth tie within a chunk by slot, not by id (C-7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .atlas import RenderInputs, SceneAtlas
from .ibl import sample_skybox
from .light_map import LightMapData
from .rasterize import geometry_stage, rasterize
from ..ops.fine_raster import MAX_CHUNK, TILES_PER_CELL
from .rasterize_tiled import CLASSIC_FINES, RASTERS, rasterize_tiled
from .shading import FrameOutputs, shade
from .shadow import SHADOW_MODES, render_shadow_maps
from .ssao import ssao_apply
from .stages import mark
from .tonemap import tone_map

TEXTURE_FILTERS = ("trilinear", "bilinear", "aniso")
SSAO_MODES = ("fast", "reference")
SHADINGS = ("pbr", "phong", "flat")  # "phong" is the PBR shader (the reference's own)
VSM_TAPS = (4, 1)
IBL_PREFILTERS = ("trilinear", "nearest")


class FrameConfig(NamedTuple):
    width: int
    height: int
    shading: str = "pbr"  # | "phong" (the same shader) | "flat" (base colour, unlit)
    ssao: bool = True
    ssao_mode: str = "fast"  # static ring taps | "reference": the exact
    # 64-sample hemisphere (ssao_shader.frag:13-57), one gather per sample
    tiled: bool = True  # binned raster (True) or brute-force oracle (False)
    shadow_size: int = 2048  # reference default (render_pass.cpp:271-294)
    max_lights: int = 3
    sample_textures: bool = True  # False skips the texture fetches
    sample_stickers: bool = True
    shadow_mode: str = "vsm"  # prefiltered moments | "pcf": the reference's 4x4
    # compare (render_shader.frag:321-338) | "off": no shadow maps
    texture_filter: str = "trilinear"  # mip-mapped, the reference's GL filter
    # (context.cpp:617-649) | "bilinear": one mip tap | "aniso": 4
    # trilinear taps along the footprint's major axis (context.cpp:635)
    alpha_peel: bool = False  # the alpha cutoff at the raster stage: pixels
    # whose winner failed it are rastered again behind it; turn on when
    # atlas.has_cutout_materials(atlas)
    alpha_peel_rounds: int = 1  # layers of overlapping cutouts covered
    # the raster: "cells" (default) or the classic span-class path, the
    # JAX package's SL_RASTER; the fields below serve the classic path
    raster: str = "cells"
    tile_capacity: int = 256  # slots of each tile's list
    big_capacity: int = 64  # "big" triangles per frame (both paths)
    fine_chunk: int = 128  # triangles per fine-kernel chunk
    pixel_stage: bool | None = None  # exact sub-4-px stage; None = F > 20,000
    fine_tiles_per_cell: int = 1  # tiles per kernel block (SL_FINE_TPG)
    backface_cull: bool = False  # drop camera-back faces of closed meshes (SL_BACKFACE_CULL)
    shadow_cull: bool = False  # the shadow pass's front-face cull (SL_SHADOW_CULL)
    vsm_taps: int = 4  # bilinear VSM tap | 1: the nearest texel (SL_VSM_TAPS)
    ibl_prefilter: str = "trilinear"  # | "nearest": one level (SL_IBL_PREFILTER)
    ibl_sh: bool = True  # SH irradiance | False: the irradiance cubemap (SL_IBL_SH)
    classic_fine: str = "kernel"  # the classic fine kernel | "scan": the JAX
    # package's XLA fine stage (use_pallas=False); classic raster only

    def check(self) -> None:
        for field, value, allowed in (
            ("shading", self.shading, SHADINGS),
            ("shadow_mode", self.shadow_mode, SHADOW_MODES),
            ("vsm_taps", self.vsm_taps, VSM_TAPS),
            ("ibl_prefilter", self.ibl_prefilter, IBL_PREFILTERS),
            ("backface_cull", self.backface_cull, (False, True)),
            ("shadow_cull", self.shadow_cull, (False, True)),
            ("ibl_sh", self.ibl_sh, (False, True)),
        ):
            if value not in allowed or type(value) is not type(allowed[0]):
                raise ValueError(f"FrameConfig: {field} {value!r} not in {allowed}")
        if self.raster not in RASTERS:
            raise ValueError(f"FrameConfig: raster {self.raster!r} not in {RASTERS}")
        if self.classic_fine not in CLASSIC_FINES:
            raise ValueError(
                f"FrameConfig: classic_fine {self.classic_fine!r} not in {CLASSIC_FINES}"
            )
        if self.classic_fine == "scan" and self.raster != "classic":
            raise ValueError('FrameConfig: classic_fine "scan" needs raster="classic"')
        if self.texture_filter not in TEXTURE_FILTERS:
            raise ValueError(
                f"FrameConfig: texture_filter {self.texture_filter!r} not in {TEXTURE_FILTERS}"
            )
        if self.ssao_mode not in SSAO_MODES:
            raise ValueError(f"FrameConfig: ssao_mode {self.ssao_mode!r} not in {SSAO_MODES}")
        if self.alpha_peel_rounds < 0:
            raise ValueError("FrameConfig: alpha_peel_rounds must be >= 0")
        if self.fine_tiles_per_cell not in TILES_PER_CELL:
            raise ValueError(
                f"FrameConfig: fine_tiles_per_cell {self.fine_tiles_per_cell} not in "
                f"{TILES_PER_CELL} (the kernel's instantiations)"
            )
        if not 0 < self.fine_chunk <= MAX_CHUNK:
            raise ValueError(
                f"FrameConfig: fine_chunk {self.fine_chunk} not in [1, {MAX_CHUNK}] (a chunk's "
                "rows must fit the fine kernel's shared memory)"
            )


class RenderedFrame(NamedTuple):
    rgb: torch.Tensor  # (H, W, 4) u8 (tone-mapped, linear)
    hdr: torch.Tensor  # (H, W, 4) f32 pre-tonemap
    object_coordinates: torch.Tensor  # (H, W, 4) f32
    cam_coordinates: torch.Tensor  # (H, W, 4) f32
    class_index: torch.Tensor  # (H, W) u16
    instance_index: torch.Tensor  # (H, W) u16
    normals: torch.Tensor  # (H, W, 4) f32
    vertex_indices: torch.Tensor  # (H, W, 3) i32
    barycentric_coeffs: torch.Tensor  # (H, W, 3) f32
    depth: torch.Tensor  # (H, W) f32
    valid: torch.Tensor  # (H, W) bool


def _select(mask: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``b`` where the (H, W) ``mask`` holds, else ``a``, for a field of any
    trailing shape; uint16 goes through int32 (no uint16 select on CUDA)."""
    mask = mask.reshape(mask.shape + (1,) * (a.dim() - 2))
    if a.dtype == torch.uint16:
        return torch.where(mask, b.to(torch.int32), a.to(torch.int32)).to(torch.uint16)
    return torch.where(mask, b, a)


def render_frame_core(
    atlas: SceneAtlas,
    inputs: RenderInputs,
    cfg: FrameConfig,
    background_image: torch.Tensor | None = None,  # (H, W, 3|4) f32 linear
    light_map: LightMapData | None = None,
    depth_peel_depth: torch.Tensor | None = None,  # (H, W) floor of the first pass
) -> RenderedFrame:
    cfg.check()
    H, W = cfg.height, cfg.width
    dev = inputs.cam_pose.device
    geom = geometry_stage(atlas, inputs, W, H)
    mark("geometry")
    flat = cfg.shading == "flat"
    shadow_maps = shadow_matrices = None
    if not flat and cfg.shadow_mode != "off":
        shadow_maps, shadow_matrices = render_shadow_maps(
            atlas, inputs, cfg.shadow_size, cfg.max_lights, cfg.raster, cfg.fine_tiles_per_cell,
            cfg.shadow_mode, cfg.shadow_cull, cfg.classic_fine,
        )
    mark("shadow pass")

    def raster_and_shade(min_depth) -> FrameOutputs:
        if cfg.tiled:
            gbuf = rasterize_tiled(
                geom, atlas, inputs, W, H, raster=cfg.raster, tile_capacity=cfg.tile_capacity,
                big_capacity=cfg.big_capacity, fine_chunk=cfg.fine_chunk,
                pixel_stage=cfg.pixel_stage, tiles_per_cell=cfg.fine_tiles_per_cell,
                min_depth=min_depth, backface_cull=cfg.backface_cull,
                classic_fine=cfg.classic_fine,
            )
        else:
            gbuf = rasterize(geom, atlas, inputs, W, H, min_depth=min_depth)
        mark("camera raster")
        return shade(
            atlas, inputs, geom, gbuf, shadow_maps, shadow_matrices, cfg.max_lights,
            light_map=light_map, sample_textures=cfg.sample_textures,
            sample_stickers=cfg.sample_stickers, texture_filter=cfg.texture_filter,
            shading=cfg.shading, shadow_mode=cfg.shadow_mode, vsm_taps=cfg.vsm_taps,
            ibl_prefilter=cfg.ibl_prefilter, ibl_sh=cfg.ibl_sh,
        )

    out = raster_and_shade(depth_peel_depth)
    for _ in range(cfg.alpha_peel_rounds if cfg.alpha_peel else 0):
        # the alpha cutoff at the raster stage: pixels whose z-winner failed
        # the cutoff are rastered again with that depth as the floor, so
        # colour and ground truth come from the surface behind the cutout,
        # as GL's fragment discard before the depth write does
        base_md = depth_peel_depth if depth_peel_depth is not None else torch.zeros((H, W), device=dev)
        out2 = raster_and_shade(torch.where(out.discarded, out.raster_depth, base_md))
        out = FrameOutputs(*(_select(out.discarded, b, a) for a, b in zip(out, out2)))
    mark("assemble")

    # SSAO multiplies the objects' RGB (reference render_pass.cpp:662-694)
    hdr_obj = out.hdr
    if cfg.ssao and not flat:
        hdr_obj = ssao_apply(hdr_obj, out.cam_coordinates, out.normals, out.valid,
                             inputs.projection, mode=cfg.ssao_mode)
    mark("SSAO")

    # background: image > skybox > colour (alpha 0: the reference clears to
    # transparent black and writes colour only through the image or skybox)
    if background_image is not None:
        bg = torch.cat([background_image[..., :3], torch.ones((H, W, 1), device=dev)], -1)
    elif light_map is not None:
        bg = torch.cat([sample_skybox(light_map, inputs, W, H), torch.ones((H, W, 1), device=dev)], -1)
    else:
        bg = torch.cat([inputs.background_color[:3], torch.zeros(1, device=dev)]).expand(H, W, 4)
    composed = torch.where(out.valid[..., None], hdr_obj, bg)
    if flat:
        mapped = torch.clamp(composed, 0.0, 1.0)
    else:
        mapped = tone_map(composed, hdr_obj * out.valid[..., None], inputs.manual_exposure)
    rgb_u8 = torch.round(torch.clamp(mapped, 0.0, 1.0) * 255.0).to(torch.uint8)
    mark("background + tone map")
    return RenderedFrame(
        rgb=rgb_u8, hdr=composed, object_coordinates=out.object_coordinates,
        cam_coordinates=out.cam_coordinates, class_index=out.class_index,
        instance_index=out.instance_index, normals=out.normals,
        vertex_indices=out.vertex_indices, barycentric_coeffs=out.barycentric_coeffs,
        depth=out.depth, valid=out.valid,
    )


# The JAX ``render_frame`` supplies an empty background image, light map and
# a peel floor of zeros so its compiled program keeps one signature; here
# ``None`` means none of them (a floor of zeros removes nothing: every depth
# is beyond the near plane, 0.1), so the name is the eager function itself.
render_frame = render_frame_core
