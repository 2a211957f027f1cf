"""Scene-driven session: the operator boundary for EXTERNAL multi-grid
simulations (≅ the reference's C++-driven entry points — updateData with
per-partner grid lists, addVolume/updateVolume/setVolumeDims,
DistributedVolumeRenderer.kt:136-160, DistributedVolumes.kt:142-250 —
driving a render loop the sim paces).

Unlike `InSituSession` (which advances a built-in sim and runs the
even-slab distributed step), `SceneSession` renders whatever grids the
driver has pushed into its `MultiGridScene` — any count, uneven extents,
ghost layers — through the whole-scene VDI path, and feeds the same
sinks and steering machinery. The driver calls ``update_data`` /
``update_grid`` between frames, as OpenFPM called the JNI callbacks;
grids that arrive as host arrays are copied to the session's device.

Each (march regime, grid-set signature, rounded world extent) gets one
step, a closure over that geometry (the ghost slices dropped along the
march axis, the slice-march spec of the extent), kept in a bounded
cache; temporal thresholds are carried per key, stacked ``[G, nj, ni]``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import FrameworkConfig
from scenery_insitu_tpu_torch.core.camera import Camera
from scenery_insitu_tpu_torch.core.scene import MultiGridScene
from scenery_insitu_tpu_torch.core.transfer import (TransferFunction,
                                                    for_dataset)
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.ops import slicer as _slicer
from scenery_insitu_tpu_torch.parallel import multihost
from scenery_insitu_tpu_torch.runtime.failsafe import SinkGuard
from scenery_insitu_tpu_torch.runtime.session import (
    advance_camera_and_index, apply_tf_steering, drain_steering,
    drop_on_regime_reentry, regime_camera)

Sink = Callable[[int, dict], None]


class SceneSession:
    """The externally driven session on one device: ``device=None``
    means CUDA and raises without a card, unless the caller passes
    ``device="cpu"``."""

    def __init__(self, cfg: Optional[FrameworkConfig] = None,
                 camera: Optional[Camera] = None,
                 tf: Optional[TransferFunction] = None,
                 sinks: Sequence[Sink] = (), log=None, device=None):
        self.cfg = cfg or FrameworkConfig()
        self.log = log or (lambda s: None)
        # obs.collector is accepted and unused, as the reference's scene
        # session pumps no publisher
        self.device = resolve_device(device)
        self.scene = MultiGridScene(self.device)
        # the same recorder-wraps-timers layering as InSituSession (spans
        # feed the PhaseStats either way; events only when obs enabled)
        self.obs = _obs.Recorder.from_config(
            self.cfg.obs, rank=multihost.process_index(), log=self.log,
            window=self.cfg.runtime.stats_window)
        self.timers = self.obs.timers
        _obs.set_recorder(self.obs)
        # the same live SLO engine — the driver paces the loop, so
        # frame_ms is observed per render_frame call
        from scenery_insitu_tpu_torch.obs.slo import SLOEngine
        self.slo = SLOEngine(self.cfg.slo, recorder=self.obs)
        self.tf = tf or for_dataset(self.cfg.runtime.dataset,
                                    device=self.device)
        self.camera = camera or Camera.create(
            (0.0, 0.6, 3.0), fov_y_deg=50.0, near=0.3, far=20.0,
            device=self.device)
        self.sinks: List[Sink] = list(sinks)
        # the same per-callable failure isolation (sinks and on_steer
        # callbacks run behind the guard)
        self._sink_guard = SinkGuard(self.cfg.fault.max_sink_failures,
                                     log=self.log)
        # the same asynchronous delivery plane: delivery.enabled runs the
        # frame sinks on a background worker; close() drains (no tile
        # path, so jobs carry no tile payloads)
        self._delivery = None
        if self.cfg.delivery.enabled:
            from scenery_insitu_tpu_torch.runtime.delivery import (
                DeliveryExecutor)
            self._delivery = DeliveryExecutor(
                self.cfg.delivery, self._sink_guard, [], self.sinks,
                recorder=self.obs, slo=self.slo, log=self.log)
        self.frame_index = 0
        self.orbit_rate = 0.0
        self.steering = None   # optional streaming.SteeringEndpoint
        self.on_steer: List[Callable[[dict], None]] = []
        self._slicer = _slicer
        self.engine = _slicer.resolve_engine(self.cfg.slicer.engine)
        self._steps = {}     # (regime, grid-set signature, ...) -> step
        self._thr = {}       # same key -> carried temporal threshold state
        self._thr_init = {}  # same key -> threshold seeder
        self._extent_cache = None  # (lo, hi, sp, rounded host tuple)
        self._temporal = (self.cfg.runtime.generate_vdis
                          and self.engine == "mxu"
                          and self.cfg.vdi.adaptive
                          and self.cfg.vdi.adaptive_mode == "temporal")
        # runtime TF updates: drop the steps (the TF is built into them)
        self.on_steer.append(self._apply_tf_message)

    def _apply_tf_message(self, msg: dict) -> None:
        """'tf' steering: drop the per-key step and threshold caches so
        the next frame builds its step with the new transfer function
        (parsing and malformed-payload containment: `apply_tf_steering`)."""
        def invalidate():
            self._steps.clear()
            self._thr.clear()
            self._thr_init.clear()

        apply_tf_steering(self, msg, invalidate)

    # ------------------------------------------------- operator boundary
    def update_data(self, partner: int, grids, origins, spacing,
                    ghost_lo=None, ghost_hi=None) -> None:
        """≅ updateData(partnerNo, numGrids, grids, origins, ...)."""
        self.scene.update_data(partner, grids, origins, spacing,
                               ghost_lo, ghost_hi)
        self._extent_cache = None

    def update_grid(self, partner: int, gid: int, data) -> None:
        """≅ updateVolume(id, buffer) — new timestep for one grid.

        Keeps the extent cache: update_grid only replaces grid DATA (the
        scene keeps origin, spacing and ghosts), so the world extent
        cannot change — and the canonical driver loop calls this every
        timestep, where reading the extent back from the device each
        frame would stall the loop. Layout changes go through
        `update_data`, which drops the cache."""
        self.scene.update_grid(partner, gid, data)

    def _args(self, cam: Camera):
        gs = self.scene.grids
        return (tuple(g.volume.data for g in gs),
                tuple(g.volume.origin for g in gs),
                tuple(g.volume.spacing for g in gs), cam)

    # -------------------------------------------------------------- frames
    def render_frame(self) -> dict:
        if self.scene.num_grids == 0:
            raise RuntimeError("no grids; call update_data first "
                               "(≅ the reference spinning on missing data, "
                               "DistributedVolumes.kt:151-153 — made loud)")
        t_f = time.perf_counter()
        drain_steering(self)
        with self.obs.span("dispatch", frame=self.frame_index,
                           engine=self.engine,
                           grids=self.scene.num_grids):
            step, key = self._step()
            args = self._args(self.camera)
            if self._temporal:
                drop_on_regime_reentry(self, self._thr, key)
                thr = self._thr.get(key)
                if thr is None:     # seed on the first frame of this key
                    thr = self._thr_init[key](*args)
                out, self._thr[key] = step(*args, thr)
            else:
                out = step(*args)
        with self.obs.span("fetch", frame=self.frame_index):
            if self.cfg.runtime.generate_vdis:
                vdi, meta = out
                payload = {"vdi_color": vdi.color.detach().cpu().numpy(),
                           "vdi_depth": vdi.depth.detach().cpu().numpy(),
                           "meta": meta._replace(index=torch.tensor(
                               self.frame_index, dtype=torch.int32))}
            else:
                payload = {"image": out.detach().cpu().numpy()}
            payload["frame"] = self.frame_index
        if self._delivery is not None:
            self._delivery.submit(self.frame_index, payload)
        else:
            with self.obs.span("sinks", frame=self.frame_index):
                self._sink_guard.run(self.sinks, self.frame_index,
                                     payload)
        advance_camera_and_index(self)
        self.timers.frame_done()
        self.slo.observe("frame_ms", (time.perf_counter() - t_f) * 1e3,
                         frame=self.frame_index - 1)
        # the driver paces this loop (no run() bracket to flush at), so
        # the obs sinks are written at every stats-window boundary
        if self.frame_index % self.timers.window == 0:
            self.obs.flush()
        return payload

    def close(self) -> None:
        """End-of-campaign teardown: drain the async delivery queue,
        flush the final partial timer window and totals, and write the
        obs sinks."""
        if self._delivery is not None:
            self._delivery.drain()
        self.timers.dump_totals()
        self.obs.flush()

    def prewarm_regimes(self, regimes=None) -> dict:
        """Build and run the step of each (axis, sign) march regime once
        against the CURRENT scene, so a regime crossing mid-session does
        not stall on a build. Call after `update_data` (a later
        signature change builds again regardless: the cache is keyed on
        both). The carried thresholds and the regime tracker are
        restored; the camera and frame index are untouched. Returns
        {(axis, sign): seconds}; {} off the slice-march VDI path, whose
        steps do not depend on the regime."""
        if self.scene.num_grids == 0:
            raise RuntimeError("no grids; call update_data first")
        if self.engine != "mxu" or not self.cfg.runtime.generate_vdis:
            return {}
        if regimes is None:
            regimes = [(a, s) for a in (0, 1, 2) for s in (1, -1)]
        cam0 = self.camera
        thr0 = dict(self._thr)
        had_last = hasattr(self, "_last_regime_key")
        last0 = getattr(self, "_last_regime_key", None)
        times = {}
        try:
            for regime in regimes:
                cam = regime_camera(cam0, regime)
                self.camera = cam
                t0 = time.perf_counter()
                step, key = self._step()
                args = self._args(cam)
                if self._temporal:
                    thr = self._thr_init[key](*args)
                    step(*args, thr)
                else:
                    step(*args)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                times[tuple(regime)] = round(time.perf_counter() - t0, 2)
        finally:
            self.camera = cam0
            # drop restored threshold entries whose step the cache bound
            # evicted, and keep the ACTIVE regime's step most recent so
            # prewarming many regimes cannot evict the one the loop is
            # about to use
            self._thr = {kk: v for kk, v in thr0.items()
                         if kk in self._steps}
            _, active_key = self._step()
            self._steps[active_key] = self._steps.pop(active_key)
            if had_last:
                self._last_regime_key = last0
            elif hasattr(self, "_last_regime_key"):
                del self._last_regime_key
        return times

    def _step(self):
        """(step, cache key) for the current camera regime and grid-set
        SIGNATURE: the grids' shapes and ghosts, and on the slice march
        the rounded global extent and spacing, from which the
        intermediate grid's spec derives. Data, origins, spacings and the
        camera are arguments, so same-extent timestep updates reuse the
        step; a driver that repartitions, moves grids or changes
        resolution builds exactly one new step."""
        regime = self._slicer.choose_axis(self.camera)
        gs = self.scene.grids
        sig = tuple((tuple(g.volume.data.shape), g.ghost_lo, g.ghost_hi)
                    for g in gs)
        mxu_vdi = (self.cfg.runtime.generate_vdis and self.engine == "mxu")
        # only the mxu spec derives from the extent; the gather and plain
        # steps take origins and spacings as arguments, so the extent in
        # THEIR key would build a step per scene movement for nothing.
        # The extent is kept on the host (dropped by update_data), so a
        # frame that hits the cache reads nothing back from the device
        extent = None
        lo = hi = sp = None
        if mxu_vdi:
            if self._extent_cache is None:
                lo, hi = self.scene.global_bounds()
                sp = gs[0].volume.spacing
                host = torch.cat([lo, hi, sp]).detach().cpu().numpy()
                self._extent_cache = (
                    lo, hi, sp, tuple(round(float(x), 5) for x in host))
            lo, hi, sp, extent = self._extent_cache
        key = (regime, sig, extent, self.engine,
               self.cfg.runtime.generate_vdis)
        step = self._steps.get(key)
        if step is not None:
            return step, key

        self.obs.count("compile_step")
        self.obs.event("compile", frame=self.frame_index,
                       what="scene_step", regime=str(regime))
        ghosts = [(g.ghost_lo, g.ghost_hi) for g in gs]
        r = self.cfg.render
        cfg = self.cfg
        tf = self.tf
        dev = self.device
        spec = None
        if mxu_vdi:
            dims = tuple(int(round(float(d))) for d in
                         ((hi - lo) / sp).detach().cpu().numpy())  # (x,y,z)
            spec = self._slicer.make_spec(self.camera,
                                          (dims[2], dims[1], dims[0]),
                                          cfg.slicer, axis_sign=regime)

        def scene_of(datas, origins, spacings):
            sc = MultiGridScene(dev)
            for i, (d, o, s) in enumerate(zip(datas, origins, spacings)):
                sc.set_grid(0, i, d, o, s, *ghosts[i])
            return sc

        if self._temporal:
            def step(datas, origins, spacings, cam, thr):
                sc = scene_of(datas, origins, spacings)
                out, meta, thr2 = sc.generate_vdi_mxu_temporal(
                    tf, cam, spec, thr, cfg.vdi, cfg.composite)
                return (out, meta), thr2

            self._thr_init[key] = (
                lambda datas, origins, spacings, cam:
                scene_of(datas, origins, spacings).initial_thresholds(
                    tf, cam, spec, cfg.vdi))
            self._steps[key] = step
            self._evict()
            return step, key

        def step(datas, origins, spacings, cam):
            sc = scene_of(datas, origins, spacings)
            if mxu_vdi:
                return sc.generate_vdi_mxu(tf, cam, spec, cfg.vdi,
                                           cfg.composite)
            if cfg.runtime.generate_vdis:
                return sc.generate_vdi(tf, cam, r.width, r.height,
                                       cfg.vdi, cfg.composite,
                                       max_steps=r.max_steps)
            return sc.render(tf, cam, r.width, r.height, r)

        self._steps[key] = step
        self._evict()
        return step, key

    _MAX_CACHED_STEPS = 8

    def _evict(self):
        """Bound the step and threshold caches: a drifting scene mints a
        new extent key per movement, and an unbounded dict would keep
        every stale step and ``[G, nj, ni]`` threshold state for the life
        of the session. Insertion order is recency here (a key is
        inserted once and then only hit), so dropping the oldest entries
        is an adequate LRU."""
        while len(self._steps) > self._MAX_CACHED_STEPS:
            old = next(iter(self._steps))
            self._steps.pop(old)
            self._thr.pop(old, None)
            self._thr_init.pop(old, None)
