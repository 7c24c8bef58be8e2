"""Whole-frame render: geometry -> shadow maps -> raster -> shade -> tone map.

Counterpart of ``stillleben_tpu/render/frame.py::render_frame_core``
(:74-199) for the datagen slice. ``FrameConfig`` keeps the JAX field names
of the options the slice implements; the others are not ported yet
(ROADMAP.md lists them) and the constructor rejects values the port does
not implement, so a config never silently means something else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .atlas import RenderInputs, SceneAtlas
from .rasterize import geometry_stage, rasterize
from ..ops.fine_raster import MAX_CHUNK, TILES_PER_CELL
from .rasterize_tiled import RASTERS, rasterize_tiled
from .shading import shade
from .shadow import render_shadow_maps
from .tonemap import tone_map


class FrameConfig(NamedTuple):
    width: int
    height: int
    shading: str = "pbr"  # only "pbr" is ported
    ssao: bool = False  # not ported: must stay False
    tiled: bool = True  # binned raster (True) or brute-force oracle (False)
    shadow_size: int = 2048  # reference default (render_pass.cpp:271-294)
    max_lights: int = 3
    sample_textures: bool = False  # not ported: must stay False
    sample_stickers: bool = False  # not ported: must stay False
    shadow_mode: str = "vsm"  # only "vsm" is ported
    alpha_peel: bool = False  # not ported: must stay False
    # the raster: "cells" (default) or the classic span-class path, the
    # JAX package's SL_RASTER; the fields below serve the classic path
    raster: str = "cells"
    tile_capacity: int = 256  # slots of each tile's list
    big_capacity: int = 64  # "big" triangles per frame (both paths)
    fine_chunk: int = 128  # triangles per fine-kernel chunk
    pixel_stage: bool | None = None  # exact sub-4-px stage; None = F > 20,000
    fine_tiles_per_cell: int = 1  # tiles per kernel block (SL_FINE_TPG)

    def check(self) -> None:
        unported = dict(
            shading=self.shading != "pbr", ssao=self.ssao,
            sample_textures=self.sample_textures, sample_stickers=self.sample_stickers,
            shadow_mode=self.shadow_mode != "vsm", alpha_peel=self.alpha_peel,
        )
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(f"FrameConfig: not ported yet: {bad}")
        if self.raster not in RASTERS:
            raise ValueError(f"FrameConfig: raster {self.raster!r} not in {RASTERS}")
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


def render_frame_core(atlas: SceneAtlas, inputs: RenderInputs, cfg: FrameConfig) -> RenderedFrame:
    cfg.check()
    H, W = cfg.height, cfg.width
    geom = geometry_stage(atlas, inputs, W, H)
    shadow_maps, shadow_matrices = render_shadow_maps(
        atlas, inputs, cfg.shadow_size, cfg.max_lights, cfg.raster, cfg.fine_tiles_per_cell
    )
    if cfg.tiled:
        gbuf = rasterize_tiled(
            geom, atlas, inputs, W, H, raster=cfg.raster, tile_capacity=cfg.tile_capacity,
            big_capacity=cfg.big_capacity, fine_chunk=cfg.fine_chunk,
            pixel_stage=cfg.pixel_stage, tiles_per_cell=cfg.fine_tiles_per_cell,
        )
    else:
        gbuf = rasterize(geom, atlas, inputs, W, H)
    out = shade(atlas, inputs, geom, gbuf, shadow_maps, shadow_matrices, cfg.max_lights)

    # background colour, alpha 0 (the reference clears to transparent black)
    bg = torch.cat([inputs.background_color[:3], torch.zeros(1, device=out.hdr.device)])
    composed = torch.where(out.valid[..., None], out.hdr, bg.expand(H, W, 4))
    mapped = tone_map(composed, out.hdr * out.valid[..., None], inputs.manual_exposure)
    rgb_u8 = torch.round(torch.clamp(mapped, 0.0, 1.0) * 255.0).to(torch.uint8)
    return RenderedFrame(
        rgb=rgb_u8, hdr=composed, object_coordinates=out.object_coordinates,
        cam_coordinates=out.cam_coordinates, class_index=out.class_index,
        instance_index=out.instance_index, normals=out.normals,
        vertex_indices=out.vertex_indices, barycentric_coeffs=out.barycentric_coeffs,
        depth=out.depth, valid=out.valid,
    )
