"""The single-chip in-situ frames: Gray-Scott advance -> VDI generation
(the slice march, or the gather engine's ray march) -> composite; the
hybrid vortex frame (the flow's VDI with its tracers splatted into it);
and the Lennard-Jones particle frame."""

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
from scenery_insitu_tpu_torch.ops.hybrid import composite_vdi_with_particles
from scenery_insitu_tpu_torch.ops.splat import speed_colors, splat_particles
from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi
from scenery_insitu_tpu_torch.sim import grayscott as gs
from scenery_insitu_tpu_torch.sim import particles as pt
from scenery_insitu_tpu_torch.sim import vortex


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
                             width: Optional[int] = None,
                             height: Optional[int] = None,
                             max_steps: int = 96, device=None):
    """Single-chip in-situ frame step. Returns ``fn(u, v, eye) -> (color,
    depth, u, v)``; with ``vdi_cfg.adaptive_mode == "temporal"`` it
    carries threshold state: ``fn(u, v, eye, thr) -> (color, depth, u,
    v, thr')``, seeded by the attribute ``fn.init_threshold(u, v, eye)``.

    ``engine="mxu"`` is the slice march ("auto" resolves to it on every
    device, ``slicer.resolve_engine``): it needs the static
    ``grid_shape`` and ``axis_sign`` (``slicer.choose_axis`` of a
    representative camera; eyes must stay in that march regime), and
    the VDI lives on the virtual axis camera's grid
    (``frame_step.spec``). ``engine="gather"`` marches ``max_steps``
    samples along every ray of a ``width`` x ``height`` image
    (``ops/vdi_gen.generate_vdi``, the reference's portable raycaster;
    ``frame_step.spec`` is None); it has no temporal thresholds and no
    ``occupancy="sim"`` (both slice-march features, raising
    ``ValueError`` as the reference does). ``sim_fused`` advances the sim through the
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
    engine = slicer.resolve_engine(engine)
    sim_occ = occupancy == "sim"
    slicer_cfg = resolve_occupancy_cfg(slicer_cfg or SliceMarchConfig(),
                                       occupancy)
    if sim_occ and engine != "mxu":
        raise ValueError("occupancy='sim' feeds the slice march's "
                         "pyramid; it needs engine='mxu'")
    if render_dtype is None:
        render_dtype = slicer_cfg.render_dtype
    else:
        slicer_cfg = dataclasses.replace(slicer_cfg,
                                         render_dtype=render_dtype)
    spec = None
    if engine == "mxu":
        if grid_shape is None:
            raise ValueError("engine='mxu' needs the static grid_shape")
        if axis_sign is None:
            raise ValueError(
                "engine='mxu' needs axis_sign — pass slicer.choose_axis("
                "cam) for a camera representative of the eyes this step "
                "will be called with")
        spec = slicer.make_spec(
            Camera.create((0.0, 0.6, 3.0), fov_y_deg=fov_y_deg,
                          device=dev),
            tuple(grid_shape), slicer_cfg, axis_sign=axis_sign)
    elif width is None or height is None:
        raise ValueError("engine='gather' needs the image width and height")
    temporal = vdi_cfg.adaptive and vdi_cfg.adaptive_mode == "temporal"
    if temporal and engine != "mxu":
        raise ValueError("adaptive_mode='temporal' needs engine='mxu'")
    if render_dtype not in ("f32", "bf16"):
        raise ValueError(f"render_dtype must be 'f32' or 'bf16', "
                         f"got {render_dtype!r}")
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
        elif engine == "mxu":
            vdi, _, _ = slicer.generate_vdi_mxu(vol, tf, cam, spec, vdi_cfg,
                                                occupancy=occ)
        else:
            vdi, _ = generate_vdi(vol, tf, cam, width, height, vdi_cfg,
                                  max_steps=max_steps)
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


def hybrid_vortex_frame_step(width: int, height: int, grid_shape, axis_sign,
                             sim_steps: int = 3,
                             vdi_cfg: Optional[VDIConfig] = None,
                             tf: Optional[TransferFunction] = None,
                             radius: float = 0.02, stamp: int = 5,
                             colormap: str = "jet", fov_y_deg: float = 50.0,
                             slicer_cfg: Optional[SliceMarchConfig] = None,
                             background=(0.0, 0.0, 0.0, 0.0), device=None):
    """Single-chip hybrid frame step (the reference's BASELINE Config 5):
    the vortex-ring flow advanced in situ, its vorticity rendered as a
    VDI on the slice march (kernels K2 and K1 on a card), passive
    tracers advected through the same flow and splatted as opaque
    spheres onto the same virtual-camera rays, merged by depth
    (``ops/hybrid.py``) and warped to the display camera.

    Returns ``fn(u_flow, tracer_pos, eye) -> (image [4, H, W], u',
    pos')``; ``tracer_pos`` is in voxel coordinates
    (``vortex.seed_tracers``). ``axis_sign`` is the march regime of the
    eyes (``slicer.choose_axis``). ``device=None`` means CUDA."""
    dev = resolve_device(device)
    tf = tf or for_dataset("hybrid", device=dev)
    vdi_cfg = vdi_cfg or VDIConfig(max_supersegments=8, adaptive_iters=2)
    params = vortex.VortexParams.create(device=dev)
    spec = slicer.make_spec(
        Camera.create((0.0, 0.6, 3.0), fov_y_deg=fov_y_deg, device=dev),
        tuple(grid_shape), slicer_cfg, axis_sign=axis_sign)

    def frame_step(u_flow, tracer_pos, eye):
        flow = vortex.VortexFlow(u_flow, params)
        for _ in range(sim_steps):
            tracer_pos = vortex.advect_tracers(flow.u, tracer_pos, params.dt)
            flow = vortex.step(flow)
        vol = Volume.centered(flow.field, extent=2.0)
        cam = Camera.create(eye, fov_y_deg=fov_y_deg, near=0.5, far=20.0,
                            device=dev)
        vdi, _, axcam = slicer.generate_vdi_mxu(vol, tf, cam, spec, vdi_cfg)
        vel = vortex.tracer_velocities(flow.u, tracer_pos)
        world = vortex.tracers_to_world(tracer_pos, vol.origin, vol.spacing)
        sp = splat_particles(world, speed_colors(vel, colormap), radius,
                             None, spec.ni, spec.nj, stamp, view=axcam.view,
                             proj=axcam.proj)
        inter = composite_vdi_with_particles(vdi, sp)
        img = slicer.warp_to_camera(inter, axcam, spec, cam, width, height,
                                    background)
        return img, flow.u, tracer_pos

    frame_step.spec = spec
    return frame_step


def lj_particle_frame_step(width: int, height: int, params: pt.LJParams,
                           spec: pt.CellSpec, sim_steps: int = 5,
                           radius: float = 0.35, stamp: int = 9,
                           colormap: str = "jet", fov_y_deg: float = 50.0,
                           device=None):
    """Single-chip in-situ particle frame step: Lennard-Jones advance ->
    speed-coloured sphere splatting. Returns ``fn(pos, vel, box, eye) ->
    (image, depth, pos, vel)``. ``params``/``spec`` come from
    ``particles.lj_init`` (or keep box / ncell >= cutoff * sigma, else
    in-range pairs drop out of the 27-cell neighbourhood).
    ``device=None`` means CUDA; the camera lies on it."""
    dev = resolve_device(device)

    def frame_step(pos, vel, box, eye):
        state = pt.lj_multi_step(pt.ParticleState(pos, vel, box), params,
                                 spec, sim_steps)
        cam = Camera.create(eye, target=(0.0, 0.0, 0.0),
                            fov_y_deg=fov_y_deg, near=0.5, far=100.0,
                            device=dev)
        # the box centred on the origin for viewing
        centered = state.pos - state.box / 2.0
        out = splat_particles(centered, speed_colors(state.vel, colormap),
                              radius, cam, width, height, stamp)
        return out.image, out.depth, state.pos, state.vel

    return frame_step
