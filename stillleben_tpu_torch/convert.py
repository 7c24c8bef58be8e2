"""Carry the JAX package's state across: NamedTuples of numpy arrays in,
the port's tensors out.

The caller turns JAX pytrees into numpy first (for example
``jax.tree.map(np.asarray, tpl)``); nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.tree import tensors_from_numpy
from .parallel.batch import SceneTemplate
from .physics.contacts import Floor
from .physics.tabletop import TabletopGeom
from .physics.types import BodyParams, BodyState, HullAtlas, SolverConfig
from .render.atlas import RenderInputs, SceneAtlas
from .render.light_map import LightMapData


def template_from_numpy(tpl, device="cuda") -> SceneTemplate:
    """A JAX ``SceneTemplate`` of numpy arrays -> the port's template on
    ``device``, textured atlas and light map (a ``LightMapData`` of numpy
    arrays, or None) included. Fields the port does not have
    (``tex_combo_quad``) are dropped."""
    params = tensors_from_numpy(BodyParams, tpl.body_params, device)
    if params.friction_static is None:  # JAX's default: the dynamic coefficient
        params = params._replace(friction_static=params.friction)
    atlas = tensors_from_numpy(SceneAtlas, tpl.render_atlas, device)
    return SceneTemplate(
        hull_atlas=tensors_from_numpy(HullAtlas, tpl.hull_atlas, device),
        body_params=params,
        pairs=torch.from_numpy(np.array(tpl.pairs)).to(device),
        tabletop_geom=tensors_from_numpy(TabletopGeom, tpl.tabletop_geom, device),
        floor=tensors_from_numpy(Floor, tpl.floor, device),
        render_atlas=atlas._replace(num_objects=int(np.asarray(tpl.render_atlas.num_objects))),
        base_inputs=tensors_from_numpy(RenderInputs, tpl.base_inputs, device),
        bbox_corners=torch.from_numpy(np.array(tpl.bbox_corners)).to(device),
        base_z=torch.from_numpy(np.array(tpl.base_z)).to(device),
        light_map=light_map_from_numpy(getattr(tpl, "light_map", None), device),
    )


def light_map_from_numpy(data, device="cuda") -> LightMapData | None:
    """A JAX ``LightMapData`` of numpy arrays -> the port's, so a test can
    feed one package's precompute into the other's shading."""
    return None if data is None else tensors_from_numpy(LightMapData, data, device)


def state_from_numpy(state, device="cuda") -> BodyState:
    """A JAX ``BodyState`` of numpy arrays -> the port's ``BodyState``.
    An unbatched state (NB, ...) gets a batch axis of 1."""
    st = tensors_from_numpy(BodyState, state, device)
    if st.pos.dim() == 2:
        st = BodyState(*(x[None] for x in st))
    return st


def accumulators_from_numpy(acc, device="cuda") -> tuple[torch.Tensor, ...]:
    """The solver's warm-start accumulators (normal, tangent 1, tangent 2),
    numpy arrays of one scene (NC,) or a batch (B, NC) -> the port's
    (B, NC) tensors; one scene gets a batch axis of 1."""
    out = tuple(torch.from_numpy(np.array(a, np.float32)).to(device) for a in acc)
    return tuple(a[None] if a.dim() == 1 else a for a in out)


def solver_config_from_jax(cfg) -> SolverConfig:
    """The values of a JAX ``SolverConfig`` (any NamedTuple with its field
    names) as the port's; fields the port does not have
    (``max_contacts_per_hull_pair``, a constant of its narrowphase) are
    dropped."""
    return SolverConfig(**{k: getattr(cfg, k) for k in SolverConfig._fields if hasattr(cfg, k)})
