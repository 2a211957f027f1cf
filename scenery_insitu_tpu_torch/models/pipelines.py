"""The single-chip in-situ frame: Gray-Scott advance -> VDI generation by
slice march -> composite."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from scenery_insitu_tpu_torch.config import (OCCUPANCY_VTILES_DEFAULT,
                                             CompositeConfig,
                                             SliceMarchConfig, VDIConfig)
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.transfer import (TransferFunction,
                                                    for_dataset)
from scenery_insitu_tpu_torch.core.volume import Volume
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops import occupancy as occupancy_mod
from scenery_insitu_tpu_torch.ops import slicer
from scenery_insitu_tpu_torch.ops.composite import composite_vdis
from scenery_insitu_tpu_torch.sim import grayscott as gs


def resolve_occupancy_cfg(slicer_cfg: SliceMarchConfig,
                          occupancy: Optional[str]) -> SliceMarchConfig:
    """Apply an empty-space-skipping mode to a SliceMarchConfig; None
    keeps it as it is. "pyramid" and "sim" turn the in-plane tiles on;
    "sim" takes the pyramid's ranges from the sim pass (see
    `grayscott_vdi_frame_step`)."""
    if occupancy is None:
        return slicer_cfg
    if occupancy not in ("off", "chunk", "pyramid", "sim"):
        raise ValueError(f"occupancy must be 'off', 'chunk', 'pyramid' "
                         f"or 'sim', got {occupancy!r}")
    if occupancy == "off":
        return dataclasses.replace(slicer_cfg, skip_empty=False)
    if occupancy == "chunk":
        return dataclasses.replace(slicer_cfg, skip_empty=True,
                                   occupancy_vtiles=0)
    vt = slicer_cfg.occupancy_vtiles
    return dataclasses.replace(
        slicer_cfg, skip_empty=True,
        occupancy_vtiles=(OCCUPANCY_VTILES_DEFAULT if vt <= 0 else vt))


def grayscott_vdi_frame_step(sim_steps: int = 5,
                             vdi_cfg: Optional[VDIConfig] = None,
                             comp_cfg: Optional[CompositeConfig] = None,
                             tf: Optional[TransferFunction] = None,
                             params: Optional[gs.GrayScottParams] = None,
                             fov_y_deg: float = 50.0,
                             engine: str = "auto",
                             grid_shape=None, axis_sign=None,
                             slicer_cfg: Optional[SliceMarchConfig] = None,
                             render_dtype: Optional[str] = None,
                             sim_fused: bool = True,
                             occupancy: Optional[str] = None,
                             device=None):
    """Single-chip in-situ frame step. Returns ``fn(u, v, eye) -> (color,
    depth, u, v)``; with ``vdi_cfg.adaptive_mode == "temporal"`` it
    carries threshold state: ``fn(u, v, eye, thr) -> (color, depth, u,
    v, thr')``, seeded by the attribute ``fn.init_threshold(u, v, eye)``.

    The engine is the slice march (``mxu``, the reference's name; "auto"
    resolves to it): it needs the static ``grid_shape`` and
    ``axis_sign`` (``slicer.choose_axis`` of a representative camera;
    eyes must stay in that march regime). The VDI lives on the virtual
    axis camera's grid (``frame_step.spec``), so unlike the reference's
    signature there is no image width, height or ray step count (those
    are the gather engine's). ``sim_fused`` advances the sim through the
    fused stencil (kernel K3 on CUDA) instead of the roll formulation.
    ``occupancy="sim"`` builds each frame's occupancy pyramid from the
    per-brick ranges of the new field that the sim pass returns (the
    stencil's ranges epilogue, or one reduction of the field when
    ``sim_fused`` is off), so the march never sweeps the volume for it.
    ``device=None`` means CUDA."""
    dev = resolve_device(device)
    tf = tf or for_dataset("gray_scott", device=dev)
    vdi_cfg = vdi_cfg or VDIConfig(max_supersegments=8, adaptive_iters=2)
    comp_cfg = comp_cfg or CompositeConfig(max_output_supersegments=8,
                                           adaptive_iters=2)
    params = params or gs.GrayScottParams.create(device=dev)
    if engine == "gather":
        raise NotImplementedError(
            "engine='gather' (ops/raycast.py, ops/vdi_gen.py) is a later "
            "slice of the port (ROADMAP queue A9)")
    if engine not in ("auto", "mxu"):
        raise ValueError(f"unknown render engine {engine!r} "
                         "(expected 'auto', 'mxu' or 'gather')")
    sim_occ = occupancy == "sim"
    slicer_cfg = resolve_occupancy_cfg(slicer_cfg or SliceMarchConfig(),
                                       occupancy)
    if render_dtype is None:
        render_dtype = slicer_cfg.render_dtype
    else:
        slicer_cfg = dataclasses.replace(slicer_cfg,
                                         render_dtype=render_dtype)
    if grid_shape is None:
        raise ValueError("engine='mxu' needs the static grid_shape")
    if axis_sign is None:
        raise ValueError(
            "engine='mxu' needs axis_sign — pass slicer.choose_axis(cam) "
            "for a camera representative of the eyes this step will be "
            "called with")
    spec = slicer.make_spec(
        Camera.create((0.0, 0.6, 3.0), fov_y_deg=fov_y_deg, device=dev),
        tuple(grid_shape), slicer_cfg, axis_sign=axis_sign)
    temporal = vdi_cfg.adaptive and vdi_cfg.adaptive_mode == "temporal"
    rdt = torch.bfloat16 if render_dtype == "bf16" else None
    advance = gs.multi_step_fast if sim_fused else gs.multi_step

    def camera(eye):
        return Camera.create(eye, fov_y_deg=fov_y_deg, near=0.5, far=20.0,
                             device=dev)

    def frame_step(u, v, eye, thr=None):
        if temporal and thr is None:
            raise ValueError(
                "temporal mode carries threshold state: call as "
                "frame_step(u, v, eye, thr), seeding thr with "
                "frame_step.init_threshold(u, v, eye)")
        if sim_occ:
            state, rng = gs.multi_step_fast_ranges(
                gs.GrayScott(u, v, params), sim_steps, fused=sim_fused)
        else:
            state = advance(gs.GrayScott(u, v, params), sim_steps)
        field = state.field if rdt is None else state.field.to(rdt)
        vol = Volume.centered(field, extent=2.0)
        occ = (occupancy_mod.pyramid_from_ranges(rng, vol, tf, spec)
               if sim_occ else None)
        cam = camera(eye)
        if temporal:
            vdi, _, _, thr = slicer.generate_vdi_mxu_temporal(
                vol, tf, cam, spec, thr, vdi_cfg, occupancy=occ)
        else:
            vdi, _, _ = slicer.generate_vdi_mxu(vol, tf, cam, spec, vdi_cfg,
                                                occupancy=occ)
        out = composite_vdis(vdi.color[None], vdi.depth[None], comp_cfg)
        if temporal:
            return out.color, out.depth, state.u, state.v, thr
        return out.color, out.depth, state.u, state.v

    if temporal:
        def init_threshold(u, v, eye):
            """Seed of the carried threshold state: one histogram counting
            march on the current sim state."""
            vol = Volume.centered(gs.GrayScott(u, v, params).field,
                                  extent=2.0)
            return slicer.initial_threshold(vol, tf, camera(eye), spec,
                                            vdi_cfg)

        frame_step.init_threshold = init_threshold
    frame_step.spec = spec
    return frame_step
